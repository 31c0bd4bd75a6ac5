"""Sub-band unfold (counterpart of ``se_tpu/ops/unfold.py``): for every
frequency bin, its ``2n + 1``-wide neighbourhood across all frames, after
reflect padding of the frequency axis, as one gather over an ``[F, 2n + 1]``
index."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def unfold(x: torch.Tensor, num_neighbor: int) -> torch.Tensor:
    """``[B, C, F, T]`` -> ``[B, F, C, 2n + 1, T]``."""
    if x.ndim != 4:
        raise ValueError(f"The dim of input is {x.ndim}. It should be four dim.")
    B, C, Fq, T = x.shape
    if num_neighbor < 1:
        return x.permute(0, 2, 1, 3).reshape(B, Fq, C, 1, T)
    xp = F.pad(x, (0, 0, num_neighbor, num_neighbor), mode="reflect")
    size = 2 * num_neighbor + 1
    idx = torch.arange(Fq, device=x.device)[:, None] + torch.arange(size, device=x.device)
    return xp[:, :, idx].permute(0, 2, 1, 3, 4)  # [B, C, F, 2n+1, T] -> [B, F, C, 2n+1, T]

