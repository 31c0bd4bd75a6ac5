"""Complex magnitude and phase (counterpart of ``se_tpu/ops/magnitude.py``).

Only the forward values are ported in this slice.  The JAX package gives
both functions a zero gradient at the origin, where the naive expressions
have a 0/0; that gradient belongs with the training path.
"""

from __future__ import annotations

import torch


def complex_mag(real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
    """``(real**2 + imag**2) ** 0.5``, with no epsilon."""
    return (real**2 + imag**2) ** 0.5


def safe_arctan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``atan2(y, x)``."""
    return torch.atan2(y, x)
