"""Command-line entry points of the port (``python -m tcs_tpu_torch.cli.<name>``)."""
