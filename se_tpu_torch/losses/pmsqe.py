"""PMSQE: the perceptually motivated speech quality loss (counterpart of
``se_tpu/losses/pmsqe.py``).

The PESQ-inspired objective of Martin-Donas et al. 2018 as the reference
applies it: 1-second chunks, a 512/256 STFT with a square-root Hann window,
MAGNITUDE spectra (the reference's ``transforms.mag``), the P.862 bark
grouping, level alignment, bark and gain equalisation, Zwicker loudness,
the disturbance dead zone and asymmetry, and the ^0.04 frame weighting
capped at 45.  The tables are the port's own copy of P.862's
(``eval/p862_tables.py``).

The P.862 gates stay ``torch.where`` selections: where's backward gives
the branch not taken a zero gradient, which keeps ``sqrt'(0) = inf`` at a
disturbance of 0 (deg == ref) from turning into NaN.  Statistics run in
f32; the constants are cast to f32 after their numpy arithmetic, as the
JAX package's numpy constants are.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..eval import p862_tables as T

FS = 16000
NFFT = 512
HOP = 256
NB = T.NB
SP = 6.910853e-006
SL = 1.866055e-001
WINDOW_CORRECTION = 2.0  # sqrt-hann: 1 / mean(w^2)

_ABS_THRESH = np.asarray(T.ABS_THRESH_POWER)
_POW_CORR = np.asarray(T.POW_DENS_CORRECTION_FACTOR)
_WIDTH_BARK = np.asarray(T.WIDTH_OF_BAND_BARK)
_CENTRE_BARK = np.asarray(T.CENTRE_OF_BAND_BARK)
_NR_HZ = np.asarray(T.NR_OF_HZ_BANDS_PER_BARK_BAND)


@lru_cache(maxsize=1)
def _bark_matrix() -> np.ndarray:
    """``[257, NB]`` grouping matrix with Sp and each band's power-density
    correction folded in; the Nyquist row is zero."""
    m = np.zeros((NFFT // 2 + 1, NB), np.float32)
    edges = np.concatenate([[0], np.cumsum(_NR_HZ)]).astype(int)
    for b in range(NB):
        m[edges[b] : edges[b + 1], b] = _POW_CORR[b] * SP
    return m


@lru_cache(maxsize=1)
def _mask_sll() -> np.ndarray:
    """``[257]`` mask of P.862's level-alignment band (350-3250 Hz), scaled
    so that ``mask . |FFT|^2`` estimates the band's power per sample."""
    m = np.zeros(NFFT // 2 + 1, np.float32)
    m[11] = 0.5 * 25.0 / 31.25
    m[12:104] = 1.0
    m[104] = 0.5
    return m * WINDOW_CORRECTION * 2.0 / NFFT**2


@lru_cache(maxsize=1)
def _zwicker() -> np.ndarray:
    h = np.where(_CENTRE_BARK < 4.0, 6.0 / (_CENTRE_BARK + 2.0), 1.0)
    return 0.23 * np.minimum(h, 2.0) ** 0.15


def _sqrt_hann(n: int) -> np.ndarray:
    """asteroid's STFT window: ``np.hanning(n + 1)[:-1] ** 0.5``."""
    return (np.hanning(n + 1)[:-1] ** 0.5).astype(np.float32)


def _f32(a, like: torch.Tensor) -> torch.Tensor:
    """A numpy constant rounded to f32, on ``like``'s device in its dtype."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(like)


def _magnitude_spectra(wav: torch.Tensor) -> torch.Tensor:
    """``[B, L]`` -> ``[B, (L - 512) // 256 + 1, 257]`` magnitude spectra of
    unpadded square-root-Hann frames."""
    frames = wav.unfold(-1, NFFT, HOP) * _f32(_sqrt_hann(NFFT), wav)
    spec = torch.fft.rfft(frames, n=NFFT)
    return torch.sqrt(spec.real**2 + spec.imag**2 + 1e-8)


def _total_audible(bark: torch.Tensor, factor: float) -> torch.Tensor:
    """``[B, T, NB]`` -> ``[B, T]``: the power of bands 1..48 above
    ``factor`` times their hearing threshold."""
    above = bark[..., 1:] > _f32(factor * _ABS_THRESH[1:], bark)
    return torch.sum(torch.where(above, bark[..., 1:], 0.0), dim=-1)


def _loudness(bark: torch.Tensor) -> torch.Tensor:
    """Zwicker loudness of each band, 0 at or below its threshold."""
    t, z = _ABS_THRESH, _zwicker()
    scale = _f32(SL * (t / 0.5) ** z, bark)
    loud = scale * ((0.5 + 0.5 * bark / _f32(t, bark)) ** _f32(z, bark) - 1.0)
    zero = torch.zeros((), dtype=loud.dtype, device=loud.device)
    return torch.where(bark > _f32(t, bark), torch.maximum(loud, zero), 0.0)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: a maximum, then a minimum (half the gradient at a tie)."""
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def pmsqe_loss(
    ref_wav: torch.Tensor,
    deg_wav: torch.Tensor,
    alpha: float = 0.1,
    beta: float = 0.309,
    bark_eq: bool = True,
    gain_eq: bool = True,
) -> torch.Tensor:
    """Mean PMSQE distortion between ``[B, L]`` (or ``[L]``) waveforms.

    As in the reference, an utterance longer than a second is scored as
    independent 1-second chunks, trimmed to its whole seconds first;
    level alignment and the equalisations are per-chunk time averages.
    A sub-second utterance is scored whole.
    """
    if ref_wav.ndim == 1:
        ref_wav, deg_wav = ref_wav[None], deg_wav[None]

    B, L = ref_wav.shape
    if L > FS:
        n_sec = L // FS
        ref_wav = ref_wav[:, : n_sec * FS].reshape(B * n_sec, FS)
        deg_wav = deg_wav[:, : n_sec * FS].reshape(B * n_sec, FS)

    s_ref = _magnitude_spectra(ref_wav)  # [B, T, 257]
    s_deg = _magnitude_spectra(deg_wav)

    # standard listening level (P.862's level-alignment band)
    mask = _f32(_mask_sll(), s_ref)
    mean_ref = torch.mean(s_ref @ mask, dim=-1)  # [B]
    mean_deg = torch.mean(s_deg @ mask, dim=-1)
    s_ref = s_ref * (1e7 / mean_ref)[:, None, None]
    s_deg = s_deg * (1e7 / mean_deg)[:, None, None]

    bark_m = _f32(_bark_matrix(), s_ref)
    bark_ref = s_ref @ bark_m  # [B, T, NB]
    bark_deg = s_deg @ bark_m

    if bark_eq:
        # partial frequency-response compensation of the degraded spectra:
        # non-silent frames, bands active above 100x their threshold, a
        # +1000 floor and a [0.01, 100] clip
        silent = (_total_audible(bark_ref, 100.0) < 1e7)[..., None]
        th100 = _f32(100.0 * _ABS_THRESH, bark_ref)
        num = torch.sum(torch.where(~silent & (bark_ref > th100), bark_ref, 0.0), dim=1)
        den = torch.sum(torch.where(~silent & (bark_deg > th100), bark_deg, 0.0), dim=1)
        eq = _clip((num + 1000.0) / (den + 1000.0), 0.01, 100.0)
        bark_deg = bark_deg * eq[:, None, :]

    if gain_eq:
        # per-frame gain equalisation of the degraded signal
        ta_ref = _total_audible(bark_ref, 1.0)
        ta_deg = _total_audible(bark_deg, 1.0)
        g = _clip((ta_ref + 5e3) / (ta_deg + 5e3), 3e-4, 5.0)[..., None]
        bark_deg = bark_deg * g

    loud_ref = _loudness(bark_ref)
    loud_deg = _loudness(bark_deg)

    d = loud_deg - loud_ref
    m = 0.25 * torch.minimum(loud_deg, loud_ref)
    d = torch.where(d > m, d - m, torch.where(d < -m, d + m, 0.0))

    ratio = ((bark_deg + 50.0) / (bark_ref + 50.0)) ** 1.2
    twelve = torch.tensor(12.0, dtype=ratio.dtype, device=ratio.device)
    asym = torch.where(ratio < 3.0, 0.0, torch.minimum(ratio, twelve))

    # width-weighted pseudo-Lp norms over bands 1..48
    w = _f32(_WIDTH_BARK[1:], d)
    total_w = torch.sum(w)
    d_sym = torch.sqrt(torch.sum((torch.abs(d[..., 1:]) * w) ** 2, -1) / total_w) * total_w
    d_asym = torch.sum(torch.abs((d * asym)[..., 1:]) * w, -1)

    # frame weighting by the reference's audible power, capped at 45
    h = ((_total_audible(bark_ref, 1.0) + 1e5) / 1e7) ** 0.04
    cap = torch.tensor(45.0, dtype=h.dtype, device=h.device)
    wd = torch.minimum(d_sym / h, cap)
    wda = torch.minimum(d_asym / h, cap)
    return alpha * torch.mean(wd) + beta * torch.mean(wda)
