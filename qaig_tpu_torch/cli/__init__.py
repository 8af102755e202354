"""Command-line entry points of the port (``python -m
qaig_tpu_torch.cli.<name>``)."""
