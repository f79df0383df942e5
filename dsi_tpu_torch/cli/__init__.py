"""Command-line entry points of the port (``python -m
dsi_tpu_torch.cli.<name>``)."""
