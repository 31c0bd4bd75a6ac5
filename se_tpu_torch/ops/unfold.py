"""Sub-band unfold (counterpart of ``se_tpu/ops/unfold.py``): for every
frequency bin, its ``2n + 1``-wide neighbourhood across all frames, after
reflect padding of the frequency axis, as one gather over an ``[F, 2n + 1]``
index; and the reference's band dropping, ``reduce_complexity_separately``."""

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



def reduce_complexity_separately(sub_band_input: torch.Tensor,
                                 full_band_output: torch.Tensor) -> torch.Tensor:
    """Three-way interleaved band dropping (tools_for_model.py:840-878,
    unused on the main path): the batch split into three sub-batches of
    ``B // 3``, sub-batch i keeping every third bin from ``i + 1`` (the
    first and last bins never), sub-band and full-band features
    concatenated.  ``[B, F, C, F_s, T]``, ``[B, F, C, F_f, T]`` ->
    ``[3 (B // 3), n, C, F_s + F_f, T]``.

    The reference concatenates the three sub-batches, which fails unless
    each keeps the same number of bins (F = 257 keeps 85 each; F = 9 keeps
    3, 2 and 2): that raises ``ValueError`` here."""
    B, n_freqs = full_band_output.shape[:2]
    sub = B // 3
    picks = [torch.arange(i + 1, n_freqs - 1, 3, device=full_band_output.device)
             for i in range(3)]
    counts = [len(p) for p in picks]
    if len(set(counts)) != 1:
        raise ValueError(
            f"reduce_complexity_separately: at F = {n_freqs} the three sub-batches keep "
            f"{counts} bins, and sub-batches of different bin counts cannot be concatenated"
        )
    parts = [torch.cat([sub_band_input[i * sub : (i + 1) * sub][:, p],
                        full_band_output[i * sub : (i + 1) * sub][:, p]], dim=-2)
             for i, p in enumerate(picks)]
    return torch.cat(parts, dim=0)
