"""NaN-safe complex magnitude and phase (counterpart of
``se_tpu/ops/magnitude.py``).

Both forwards are bit-identical to the naive expressions.  Their
gradients are those of the naive expressions everywhere except at the
origin, where those have a 0/0: there the gradient is defined as 0, as in
the JAX package.  The DCCRN E-mask takes both of the mask's parts, which
can be exactly zero.  Both inputs of each function have the same shape.
"""

from __future__ import annotations

import torch


class _ComplexMag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, real, imag):
        m = (real**2 + imag**2) ** 0.5
        ctx.save_for_backward(real, imag, m)
        return m

    @staticmethod
    def backward(ctx, grad):
        real, imag, m = ctx.saved_tensors
        s = grad / torch.where(m > 0, m, torch.ones_like(m))
        return real * s, imag * s


class _SafeArctan2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, x):
        ctx.save_for_backward(y, x)
        return torch.atan2(y, x)

    @staticmethod
    def backward(ctx, grad):
        y, x = ctx.saved_tensors
        denom = x * x + y * y
        s = grad / torch.where(denom > 0, denom, torch.ones_like(denom))
        return x * s, -y * s


def complex_mag(real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
    """``(real**2 + imag**2) ** 0.5``, with no epsilon; zero gradient at
    the origin."""
    return _ComplexMag.apply(real, imag)


def safe_arctan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``atan2(y, x)``; zero gradient at the origin."""
    return _SafeArctan2.apply(y, x)
