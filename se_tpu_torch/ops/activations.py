"""Activations with torch-parity parameterisation (counterpart of
``se_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``max(0, x) + alpha * min(0, x)`` with one shared slope."""
    return x.clamp_min(0) + alpha.to(x.dtype) * x.clamp_max(0)
