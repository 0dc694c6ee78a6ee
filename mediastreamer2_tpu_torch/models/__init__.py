"""Graph builders of whole pipelines."""
