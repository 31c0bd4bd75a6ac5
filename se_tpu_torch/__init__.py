"""PyTorch/CUDA port of se_tpu for NVIDIA Hopper.

Imports nothing of JAX or of the ``se_tpu`` package: it keeps its own
copies of what it needs.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

from .config import Config, default_config, tutorial_config
