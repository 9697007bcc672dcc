"""Command-line probes and timing runs of the port
(``python -m ohm_tpu_torch.scripts.<name>``)."""
