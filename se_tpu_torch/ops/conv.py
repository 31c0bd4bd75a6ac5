"""2-D convolution and transposed convolution in torch's NCHW layout
(counterpart of ``conv2d`` and ``conv_transpose2d`` in
``se_tpu/ops/conv.py``).  The JAX package left these to XLA outside any
Pallas kernel; here they go to ``F.conv2d`` and ``F.conv_transpose2d``.

Weights and biases are cast to the activation dtype, as the reference's
mixed-precision path casts its f32 master weights.  In bf16 the bias is
added after the convolution, as the reference writes it: the convolution's
output is rounded to bf16, then the sum with the bias is rounded again.
Fusing the add into the convolution would round once, and differ from the
reference in about a third of the elements.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _with_bias(conv, x, w, b):
    """``conv(x, w, bias)`` with the weights in x's dtype; in bf16 the bias
    added to the rounded output."""
    w = w.to(x.dtype)
    b = b.to(x.dtype) if b is not None else None
    if b is None or x.dtype == torch.float32:
        return conv(x, w, b)
    return conv(x, w, None) + b[None, :, None, None]


def conv2d(x, w, b=None, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """``x [B, C, H, W]``, ``w [O, C, kh, kw]``."""
    return _with_bias(
        lambda x, w, b: F.conv2d(x, w, b, stride=tuple(stride), padding=tuple(padding)),
        x, w, b,
    )


def conv_transpose2d(
    x, w, b=None, stride=(1, 1), padding=(0, 0), output_padding=(0, 0)
) -> torch.Tensor:
    """``x [B, I, H, W]``, ``w [I, O, kh, kw]``; output spatial size
    ``(H - 1) * s - 2p + k + op``."""
    return _with_bias(
        lambda x, w, b: F.conv_transpose2d(
            x, w, b, stride=tuple(stride), padding=tuple(padding),
            output_padding=tuple(output_padding),
        ),
        x, w, b,
    )
