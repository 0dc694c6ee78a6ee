"""The port's command-line programs (``python -m mediastreamer2_tpu_torch.tools.<name>``)."""
