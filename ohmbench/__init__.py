"""ohmbench: the benchmark of ohm_tpu_torch (see ohmbench/run.py)."""
