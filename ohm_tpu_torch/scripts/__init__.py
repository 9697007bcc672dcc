"""Command-line probes of the port (``python -m ohm_tpu_torch.scripts.<name>``)."""
