"""BatchNorm with torch semantics, the complex (whitening) BatchNorm and
FullSubNet's normalisations (counterpart of ``batch_norm_2d``,
``complex_batch_norm``, the four norms of ``norm_wrapper`` and
``norm_wrapper`` itself in ``se_tpu/ops/norms.py``).

The FullSubNet norms take ``[B, C, F, T]`` and keep their statistics in
f32.  ``valid_frames`` (a scalar or one count per sample) restricts the
offline norms' statistics to the first ``valid_frames`` frames; the
cumulative norms are causal prefix statistics and ignore it.  Their
chunk-carry forms (``cumulative_*_norm_carry``, chosen by
``stream_norm_wrapper``) normalise a stream chunk by chunk, carrying the
running sums and the entry count.  The forgetting-EMA norms
(``forgetting_norm``, ``sband_forgetting_norm``, ``hybrid_norm``) take
``[B, F, T]`` and, as in the JAX package, are exported but not in
``norm_wrapper``'s table.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import shard

EPSILON = float(np.finfo(np.float32).eps)


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
    ``momentum``; evaluation normalises with the running buffers.  Inside
    ``shard.shard_context`` the statistics are the global batch's, and
    the gradient flows through them to every rank's rows.
    """
    if train:
        # the batch's sum and count, then its centred sum of squares, each
        # all-reduced inside shard.shard_context (the identity outside it).
        # One formula in both contexts, so a group of one computes a single
        # process's bits; on the card torch's mean (the sum times 1/n) parts
        # from sum / n in the last bit, which Adam's first steps amplify
        sums = shard.all_reduce_sum(torch.cat([
            x.sum(dim=(0, 2, 3), dtype=torch.float32),
            _count(x, x.shape[1]),
        ]))
        n = sums[-1]
        mean = sums[:-1] / n
        xc = x - mean.to(x.dtype)[None, :, None, None]
        var = shard.all_reduce_sum(xc.square().sum(dim=(0, 2, 3), dtype=torch.float32)) / n
        unbiased = var * n / (n - 1).clamp(min=1)
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


def _count(x: torch.Tensor, channels: int) -> torch.Tensor:
    """``[1]`` f32: the values per channel of ``x``, exact below 2**24."""
    return torch.full((1,), x.numel() // channels, dtype=torch.float32, device=x.device)


class ComplexBnState(NamedTuple):
    """The complex BatchNorm's running statistics, each ``[C]``: the means of
    the real and imaginary parts and their 2x2 covariance."""

    RMr: torch.Tensor
    RMi: torch.Tensor
    RVrr: torch.Tensor
    RVri: torch.Tensor
    RVii: torch.Tensor


def complex_batch_norm(
    x: torch.Tensor,
    Wrr: torch.Tensor,
    Wri: torch.Tensor,
    Wii: torch.Tensor,
    Br: torch.Tensor,
    Bi: torch.Tensor,
    state: ComplexBnState,
    train: bool,
    momentum: float = 0.1,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, ComplexBnState]:
    """Whitening BatchNorm of ``x [B, 2C, H, W]`` (the real block over the
    imaginary block on the channels) -> ``(y, new state)``.

    Each channel's (real, imaginary) pair is centred, multiplied by the
    inverse square root of its 2x2 covariance ``[[Vrr, Vri], [Vri, Vii]]``
    (eps added to the diagonal), then by the symmetric matrix ``[[Wrr, Wri],
    [Wri, Wii]]``, and shifted by ``(Br, Bi)``.  Training uses the batch's
    means and biased covariance and moves the running statistics toward them
    by ``momentum``; evaluation uses the running statistics.  The new state
    carries no gradient.  Inside ``shard.shard_context`` the means and the
    covariance are the global batch's, as in :func:`batch_norm_2d`."""
    C2 = x.shape[1]
    xr, xi = x[:, : C2 // 2], x[:, C2 // 2 :]
    vdim = (1, C2 // 2, 1, 1)
    redux = (0, 2, 3)
    lerp = lambda old, new: ((1 - momentum) * old + momentum * new.detach().reshape(-1))

    # inside shard.shard_context: the global batch's sums and count, in f32,
    # all-reduced over the group
    if train and shard.active() is not None:
        C = C2 // 2
        sums = shard.all_reduce_sum(torch.cat([
            xr.sum(dim=redux, dtype=torch.float32), xi.sum(dim=redux, dtype=torch.float32),
            _count(xr, C),
        ]))
        n = sums[-1]
        Mr = (sums[:C] / n).to(x.dtype).reshape(vdim)
        Mi = (sums[C : 2 * C] / n).to(x.dtype).reshape(vdim)
        new_RMr, new_RMi = lerp(state.RMr, Mr), lerp(state.RMi, Mi)
    elif train:
        Mr = xr.mean(dim=redux, keepdim=True)
        Mi = xi.mean(dim=redux, keepdim=True)
        new_RMr, new_RMi = lerp(state.RMr, Mr), lerp(state.RMi, Mi)
    else:
        Mr, Mi = state.RMr.reshape(vdim), state.RMi.reshape(vdim)
        new_RMr, new_RMi = state.RMr, state.RMi
    xr, xi = xr - Mr, xi - Mi

    if train and shard.active() is not None:
        sums = shard.all_reduce_sum(torch.cat([
            (a * b).sum(dim=redux, dtype=torch.float32) for a, b in ((xr, xr), (xr, xi), (xi, xi))
        ])) / n
        Vrr, Vri, Vii = (v.to(x.dtype).reshape(vdim) for v in sums.chunk(3))
    elif train:
        Vrr = (xr * xr).mean(dim=redux, keepdim=True)
        Vri = (xr * xi).mean(dim=redux, keepdim=True)
        Vii = (xi * xi).mean(dim=redux, keepdim=True)
    if train:
        new_RVrr, new_RVri, new_RVii = (lerp(state.RVrr, Vrr), lerp(state.RVri, Vri),
                                        lerp(state.RVii, Vii))
    else:
        Vrr, Vri, Vii = (state.RVrr.reshape(vdim), state.RVri.reshape(vdim),
                         state.RVii.reshape(vdim))
        new_RVrr, new_RVri, new_RVii = state.RVrr, state.RVri, state.RVii
    Vrr = Vrr + eps
    Vii = Vii + eps

    # inverse matrix square root of [[Vrr, Vri], [Vri, Vii]]
    tau = Vrr + Vii
    delta = Vrr * Vii - Vri * Vri
    s = torch.sqrt(delta)
    t = torch.sqrt(tau + 2 * s)
    rst = 1.0 / (s * t)
    Urr = (s + Vii) * rst
    Uii = (s + Vrr) * rst
    Uri = -Vri * rst

    Wrr_, Wri_, Wii_ = Wrr.reshape(vdim), Wri.reshape(vdim), Wii.reshape(vdim)
    Zrr = Wrr_ * Urr + Wri_ * Uri
    Zri = Wrr_ * Uri + Wri_ * Uii
    Zir = Wri_ * Urr + Wii_ * Uri
    Zii = Wri_ * Uri + Wii_ * Uii

    yr = Zrr * xr + Zri * xi + Br.reshape(vdim)
    yi = Zir * xr + Zii * xi + Bi.reshape(vdim)
    out = torch.cat([yr, yi], dim=1)
    return out, ComplexBnState(new_RMr, new_RMi, new_RVrr, new_RVri, new_RVii)


def _frame_mask(x: torch.Tensor, valid_frames):
    """``([B or 1, 1, 1, T] f32 mask of the valid frames, [B or 1, 1, 1, 1]
    counts as f32)``."""
    vf = torch.as_tensor(valid_frames, device=x.device).reshape(-1, 1, 1, 1)
    tmask = (torch.arange(x.shape[3], device=x.device) < vf).float()
    return tmask, vf.float()


def offline_laplace_norm(x: torch.Tensor, valid_frames=None) -> torch.Tensor:
    """Divide by the utterance's mean (the config default)."""
    if valid_frames is None:
        mu = x.mean(dim=(1, 2, 3), keepdim=True, dtype=torch.float32)
    else:
        tmask, vf = _frame_mask(x, valid_frames)
        n = x.shape[1] * x.shape[2] * vf
        mu = (x.float() * tmask).sum(dim=(1, 2, 3), keepdim=True) / n
    return x / (mu + 1e-5).to(x.dtype)


def cumulative_laplace_norm(x: torch.Tensor, valid_frames=None) -> torch.Tensor:
    """Divide by the running mean over frequencies and frames so far."""
    B, C, F, T = x.shape
    xr = x.reshape(B * C, F, T)
    cum_sum = xr.sum(dim=1, dtype=torch.float32).cumsum(dim=-1)  # [BC, T]
    entry_count = torch.arange(F, F * T + 1, F, device=x.device, dtype=torch.float32)[None, :]
    cum_mean = (cum_sum / entry_count)[:, None, :]
    return (xr / (cum_mean + EPSILON).to(x.dtype)).reshape(B, C, F, T)


def offline_gaussian_norm(x: torch.Tensor, valid_frames=None) -> torch.Tensor:
    """Subtract the utterance's mean and divide by its unbiased std."""
    xf = x.float()
    if valid_frames is None:
        mu = xf.mean(dim=(1, 2, 3), keepdim=True)
        n = x.shape[1] * x.shape[2] * x.shape[3]
        var = (xf - mu).square().mean(dim=(1, 2, 3), keepdim=True) * n / max(n - 1, 1)
    else:
        tmask, vf = _frame_mask(x, valid_frames)
        n = x.shape[1] * x.shape[2] * vf
        mu = (xf * tmask).sum(dim=(1, 2, 3), keepdim=True) / n
        var = ((xf - mu).square() * tmask).sum(dim=(1, 2, 3), keepdim=True) / (n - 1).clamp(min=1.0)
    return (x - mu.to(x.dtype)) / (var.sqrt() + 1e-5).to(x.dtype)


def cumulative_layer_norm(x: torch.Tensor, valid_frames=None) -> torch.Tensor:
    """Subtract the running mean and divide by the running std, from running
    sums of x and x^2."""
    B, C, F, T = x.shape
    xr = x.reshape(B * C, F, T)
    cum_sum = xr.sum(dim=1, dtype=torch.float32).cumsum(dim=-1)
    cum_pow = xr.float().square().sum(dim=1).cumsum(dim=-1)
    entry_count = torch.arange(F, F * T + 1, F, device=x.device, dtype=torch.float32)[None, :]
    cum_mean = cum_sum / entry_count
    cum_var = (cum_pow - 2 * cum_mean * cum_sum) / entry_count + cum_mean**2
    cum_std = (cum_var + EPSILON).sqrt()
    out = (xr - cum_mean[:, None, :].to(x.dtype)) / cum_std[:, None, :].to(x.dtype)
    return out.reshape(B, C, F, T)


# -- the forgetting-EMA norms (tools_for_model.py:881-994) ------------------
#
# mu_t = alp_t mu_{t-1} + (1 - alp_t) stat_t from mu_{-1} = 0, with the
# reference's warm-up quirk alp_t = min((t - 1) / (t + 1), alpha) for t <
# sample_length: alp_0 = -1 (so mu_0 = 2 stat_0) and alp_1 = 0.  A closed
# form through the cumulative product of alp would divide by alp_1 = 0, so
# this is the plain loop over frames, as the JAX package's scan.


def _forgetting_alpha(x: torch.Tensor, sample_length: int) -> torch.Tensor:
    """``alp_t`` over the ``T`` frames of ``x [B, F, T]``, in its dtype."""
    alpha = torch.tensor((sample_length - 1) / (sample_length + 1), dtype=x.dtype,
                         device=x.device)
    t = torch.arange(x.shape[2], device=x.device, dtype=x.dtype)
    return torch.where(t < sample_length, torch.minimum((t - 1) / (t + 1), alpha), alpha)


def _ema_mu(stat: torch.Tensor, alp: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` frame statistics and ``[T]`` forgetting factors -> ``[B, T]``
    EMA means."""
    mu = torch.zeros_like(stat[:, 0])
    out = []
    for t in range(stat.shape[1]):
        mu = alp[t] * mu + (1 - alp[t]) * stat[:, t]
        out.append(mu)
    return torch.stack(out, dim=1)


def forgetting_norm(x: torch.Tensor, sample_length: int) -> torch.Tensor:
    """``[B, F, T]`` divided by the EMA of each frame's mean over
    frequencies (the warm-up quirk above; alpha after ``sample_length``
    frames)."""
    alp = _forgetting_alpha(x, sample_length)
    mu = _ema_mu(x.mean(dim=1), alp)
    return x / (mu[:, None, :] + 1e-10)


def sband_forgetting_norm(x: torch.Tensor, train_sample_length: int) -> torch.Tensor:
    """As :func:`forgetting_norm`, but after the warm-up the statistic is the
    value of bin ``F // 2 - 1``."""
    B, F, T = x.shape
    alp = _forgetting_alpha(x, train_sample_length)
    warm = torch.arange(T, device=x.device) < train_sample_length
    stat = torch.where(warm[None, :], x.mean(dim=1), x[:, F // 2 - 1, :])
    mu = _ema_mu(stat, alp)
    return x / (mu[:, None, :] + 1e-10)


def hybrid_norm(x: torch.Tensor, sample_length: int = 192) -> torch.Tensor:
    """The EMA of the frequency mean during the first ``sample_length``
    frames, the cumulative mean over frequencies and frames after."""
    B, F, T = x.shape
    alp = _forgetting_alpha(x, sample_length)
    mu_warm = _ema_mu(x.mean(dim=1), alp)
    entry_count = torch.arange(F, F * T + 1, F, device=x.device, dtype=x.dtype)[None, :]
    cum_mean = x.sum(dim=1).cumsum(dim=-1) / entry_count
    t = torch.arange(T, device=x.device)
    mu = torch.where(t[None, :] < sample_length, mu_warm, cum_mean)
    return x / (mu[:, None, :] + 1e-10)


# -- chunk-carry forms of the cumulative norms (stream inference) ----------
#
# A cumulative norm's statistics are causal prefix sums, so a stream can
# normalise a chunk of frames at a time, carrying (running sum, [running
# power sum,] entry count).  As in the JAX package, the carry is added to
# the chunk's own cumsum, so the result equals the batch norm over the
# concatenated chunks up to f32 rounding of that one sum.


def init_cumulative_carry(n_rows: int, with_pow: bool, device=None) -> tuple:
    """A fresh carry for ``n_rows = B * C`` rows: ``(sum, [pow_sum,] count)``,
    f32, the sums ``[n_rows]`` and the count a scalar."""
    zeros = torch.zeros(n_rows, dtype=torch.float32, device=device)
    count = torch.zeros((), dtype=torch.float32, device=device)
    return (zeros, zeros.clone(), count) if with_pow else (zeros, count)


def _chunk_sums(x: torch.Tensor, carry_sums, prev_count):
    """The running sums over the chunk's frames, each ``[BC, T]`` f32, and
    the entry counts ``[1, T]``: the carried sums plus the chunk's cumsums of
    each statistic in ``carry_sums``' order (x, then x^2)."""
    B, C, F, T = x.shape
    xf = x.reshape(B * C, F, T).float()
    steps = (xf.sum(dim=1), xf.square().sum(dim=1))[: len(carry_sums)]
    cums = [prev[:, None] + step.cumsum(dim=-1) for prev, step in zip(carry_sums, steps)]
    count = prev_count + torch.arange(F, F * T + 1, F, device=x.device,
                                      dtype=torch.float32)[None, :]
    return cums, count


def cumulative_laplace_norm_carry(x: torch.Tensor, carry) -> tuple:
    """A chunk ``[B, C, F, T]`` and its carry -> ``(normed, new carry)``.
    The statistics are f32 whatever x's dtype, as the batch norm's."""
    B, C, F, T = x.shape
    prev_sum, prev_count = carry
    (cum_sum,), count = _chunk_sums(x, (prev_sum,), prev_count)
    cum_mean = (cum_sum / count)[:, None, :].to(x.dtype)
    y = (x.reshape(B * C, F, T) / (cum_mean + EPSILON)).reshape(B, C, F, T)
    return y, (cum_sum[:, -1], prev_count + F * T)


def cumulative_layer_norm_carry(x: torch.Tensor, carry) -> tuple:
    """A chunk ``[B, C, F, T]`` and its carry -> ``(normed, new carry)``,
    f32 statistics whatever x's dtype."""
    B, C, F, T = x.shape
    prev_sum, prev_pow, prev_count = carry
    (cum_sum, cum_pow), count = _chunk_sums(x, (prev_sum, prev_pow), prev_count)
    cum_mean = cum_sum / count
    cum_var = (cum_pow - 2 * cum_mean * cum_sum) / count + cum_mean**2
    cum_std = (cum_var + EPSILON).sqrt()
    xr = x.reshape(B * C, F, T)
    y = (xr - cum_mean[:, None, :].to(x.dtype)) / cum_std[:, None, :].to(x.dtype)
    return y.reshape(B, C, F, T), (cum_sum[:, -1], cum_pow[:, -1], prev_count + F * T)


def stream_norm_wrapper(norm_type: str):
    """``(norm(x, carry) -> (y, carry), init(n_rows, device) -> carry)`` of a
    cumulative norm; the offline norms take utterance-wide statistics, which
    have no causal form, and raise."""
    if norm_type == "cumulative_laplace_norm":
        return cumulative_laplace_norm_carry, lambda n, device=None: init_cumulative_carry(
            n, False, device)
    if norm_type == "cumulative_layer_norm":
        return cumulative_layer_norm_carry, lambda n, device=None: init_cumulative_carry(
            n, True, device)
    raise NotImplementedError(f"streaming requires a cumulative norm, got {norm_type!r}")


_NORMS = {
    "offline_laplace_norm": offline_laplace_norm,
    "cumulative_laplace_norm": cumulative_laplace_norm,
    "offline_gaussian_norm": offline_gaussian_norm,
    "cumulative_layer_norm": cumulative_layer_norm,
}


def norm_wrapper(norm_type: str):
    """The FullSubNet norm named ``norm_type``."""
    if norm_type not in _NORMS:
        raise NotImplementedError(
            "You must set up a type of Norm, e.g. offline_laplace_norm, "
            f"cumulative_laplace_norm, ...; got {norm_type!r}"
        )
    return _NORMS[norm_type]
