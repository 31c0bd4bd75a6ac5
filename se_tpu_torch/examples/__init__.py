"""User examples of the port, each run as ``python -m se_tpu_torch.examples.<name>``."""
