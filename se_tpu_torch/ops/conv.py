"""2-D convolution and transposed convolution in torch's NCHW layout
(counterpart of ``conv2d`` and ``conv_transpose2d`` in
``se_tpu/ops/conv.py``).  The JAX package left these to XLA outside any
Pallas kernel; here they go to ``F.conv2d`` and ``F.conv_transpose2d``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x, w, b=None, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """``x [B, C, H, W]``, ``w [O, C, kh, kw]``; weights are cast to the
    activation dtype."""
    b = b.to(x.dtype) if b is not None else None
    return F.conv2d(x, w.to(x.dtype), b, stride=tuple(stride), padding=tuple(padding))


def conv_transpose2d(
    x, w, b=None, stride=(1, 1), padding=(0, 0), output_padding=(0, 0)
) -> torch.Tensor:
    """``x [B, I, H, W]``, ``w [I, O, kh, kw]``; output spatial size
    ``(H - 1) * s - 2p + k + op``."""
    b = b.to(x.dtype) if b is not None else None
    return F.conv_transpose2d(
        x,
        w.to(x.dtype),
        b,
        stride=tuple(stride),
        padding=tuple(padding),
        output_padding=tuple(output_padding),
    )
