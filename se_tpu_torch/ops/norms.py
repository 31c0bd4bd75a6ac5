"""BatchNorm with torch semantics (counterpart of ``batch_norm_2d`` in
``se_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch


def batch_norm_2d(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    train: bool,
    momentum: float = 0.1,
    eps: float = 1e-5,
):
    """``[B, C, H, W]`` batch norm -> ``(y, new_running_mean, new_running_var)``.

    Training normalises with the biased batch statistics and moves the
    running buffers toward the mean and the unbiased variance by
    ``momentum``; evaluation normalises with the running buffers.
    """
    if train:
        mean = x.mean(dim=(0, 2, 3), dtype=torch.float32)
        xc = x - mean.to(x.dtype)[None, :, None, None]
        var = xc.square().mean(dim=(0, 2, 3), dtype=torch.float32)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        unbiased = var * n / max(n - 1, 1)
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    inv = torch.rsqrt(var + eps)
    y = (x - mean.to(x.dtype)[None, :, None, None]) * (scale * inv).to(x.dtype)[
        None, :, None, None
    ]
    y = y + bias.to(x.dtype)[None, :, None, None]
    return y, new_mean, new_var
