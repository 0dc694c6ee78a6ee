"""Core runtime: formats, filter descriptors, factory, graph."""
