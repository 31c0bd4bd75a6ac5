"""Overlap-add synthesis (counterpart of ``se_tpu/dsp/ola.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add ``frames [..., T, N]`` at ``hop`` -> ``[..., (T-1)*hop + N]``.

    Each frame is cut into ``R = ceil(N / hop)`` hop-sized blocks; block
    ``r`` of frame ``t`` lands at ``(t + r) * hop``, so the sum is R
    shifted adds of contiguous ``T * hop`` strips.
    """
    *lead, T, N = frames.shape
    R = -(-N // hop)
    out_len = (T - 1) * hop + N
    if R * hop != N:
        frames = F.pad(frames, (0, R * hop - N))
    blocks = frames.reshape(*lead, T, R, hop)
    strip_len = T * hop
    out = frames.new_zeros((*lead, (T - 1) * hop + R * hop))
    for r in range(R):
        out[..., r * hop : r * hop + strip_len] += blocks[..., :, r, :].reshape(
            *lead, strip_len
        )
    return out[..., :out_len]
