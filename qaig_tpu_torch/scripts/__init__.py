"""Measurement scripts of the port (``python -m
qaig_tpu_torch.scripts.<name>``)."""
