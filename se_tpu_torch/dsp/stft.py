"""The two STFT paths of ``se_tpu/dsp/stft.py``.

Conv-STFT of DCCRN/CRN: the analysis is a framing plus one
``[win_len, fft_len + 2]`` product with the windowed rFFT basis; the
synthesis is the transposed product with the basis' pseudo-inverse, an
overlap-add, a division by the overlap-added squared window and an edge
trim.

Framework STFT of FullSubNet (:func:`stft`, :func:`istft`,
:func:`mag_phase`): ``torch.stft``/``torch.istft`` semantics (center,
reflect padding, a periodic Hann window of ``win_length`` centred in
``n_fft``, onesided), written out as framing, ``torch.fft.rfft`` and an
overlap-add, as the JAX package writes them, so the least-squares envelope
and the ``length`` handling are its own.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import get_window

from .ola import overlap_add

# scipy >= 1.13 dropped the 'hanning' alias the reference config uses
_WINDOW_ALIASES = {"hanning": "hann", "hamming": "hamming"}


def _window_np(win_type: str | None, win_len: int) -> np.ndarray:
    if win_type is None or win_type == "None":
        return np.ones(win_len)
    win_type = _WINDOW_ALIASES.get(win_type, win_type)
    return get_window(win_type, win_len, fftbins=True)


def conv_stft_bases(win_len: int, fft_len: int, win_type: str | None):
    """(forward basis, inverse basis, window), each float32.

    Both bases are ``[win_len, fft_len + 2]``: the rFFT basis rows
    (real parts then imaginary parts) times the window, and the float64
    pseudo-inverse of that basis times the window, cast afterwards.
    """
    window = _window_np(win_type, win_len)
    fourier_basis = np.fft.rfft(np.eye(fft_len))[:win_len]
    basis = np.concatenate([np.real(fourier_basis), np.imag(fourier_basis)], axis=1)
    fwd = (basis * window[:, None]).astype(np.float32)
    inv = (np.linalg.pinv(basis.T) * window[:, None]).astype(np.float32)
    return fwd, inv, window.astype(np.float32)


def conv_stft(x: torch.Tensor, fwd: torch.Tensor, win_len: int, hop: int) -> torch.Tensor:
    """``x [B, L]`` -> ``[B, fft_len + 2, T]``, real parts stacked over
    imaginary parts.  The signal is zero-padded by ``win_len - hop`` on
    both sides before framing at ``hop``.  ``fwd`` is ``[win_len, fft_len + 2]``.
    """
    if x.ndim == 1:
        x = x[None]
    pad = win_len - hop
    frames = F.pad(x, (pad, pad)).unfold(-1, win_len, hop)  # [B, T, win_len]
    return torch.einsum("btn,nf->bft", frames, fwd)


def conv_istft(
    spec: torch.Tensor, inv: torch.Tensor, window: torch.Tensor, hop: int
) -> torch.Tensor:
    """``spec [B, fft_len + 2, T]`` -> ``[B, 1, L]``.

    Divides the overlap-add by the overlap-added squared window plus 1e-8,
    then trims ``win_len - hop`` samples at both ends (nothing when the
    frames do not overlap).
    """
    win_len = inv.shape[0]
    T = spec.shape[-1]
    out = overlap_add(torch.einsum("bft,nf->btn", spec, inv), hop)
    win_sq = (window**2)[None, None, :].expand(1, T, win_len)
    out = out / (overlap_add(win_sq, hop) + 1e-8)
    trim = win_len - hop
    if trim:
        out = out[..., trim:-trim]
    return out[:, None, :]


def _centered_window(win_length: int, n_fft: int, device) -> torch.Tensor:
    """A periodic Hann window of ``win_length`` zero-padded to ``n_fft``,
    centred (torch.stft semantics)."""
    w = torch.zeros(n_fft, dtype=torch.float32)
    left = (n_fft - win_length) // 2
    n = torch.arange(win_length, dtype=torch.float64)
    w[left : left + win_length] = (0.5 - 0.5 * torch.cos(2.0 * np.pi * n / win_length)).float()
    return w.to(device)


def _reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """``y [B, L]`` reflect-padded by ``pad`` at each end, as ``numpy.pad``
    (and ``jnp.pad``) reflect: a pad longer than the signal reflects back
    and forth through it."""
    L = y.shape[-1]
    i = torch.arange(-pad, L + pad, device=y.device)
    if L == 1:
        return y[..., torch.zeros_like(i)]
    period = 2 * (L - 1)
    m = i.remainder(period)
    return y[..., torch.where(m < L, m, period - m)]


def stft(y: torch.Tensor, n_fft: int = 512, hop_length: int = 300,
         win_length: int = 400) -> torch.Tensor:
    """``y [B, L]`` -> ``[B, n_fft // 2 + 1, T]`` complex64: centred frames
    (``n_fft // 2`` samples of reflect padding at each end) at
    ``hop_length``, windowed, rFFT."""
    if y.ndim == 1:
        y = y[None]
    window = _centered_window(win_length, n_fft, y.device)
    frames = _reflect_pad(y, n_fft // 2).unfold(-1, n_fft, hop_length) * window  # [B, T, n_fft]
    return torch.fft.rfft(frames, n=n_fft).transpose(-1, -2)


def istft(features: torch.Tensor, n_fft: int = 512, hop_length: int = 300,
          win_length: int = 400, length=None) -> torch.Tensor:
    """``features [B, F, T]`` complex or ``[B, F, T, 2]`` real/imaginary ->
    ``[B, length]``: inverse rFFT, window, overlap-add, division by the
    overlap-added squared window where it exceeds 1e-11, the centre padding
    dropped.  A ``length`` past the reconstructable span is zero-filled, as
    ``torch.istft`` does."""
    if features.ndim == 4:
        features = torch.complex(features[..., 0], features[..., 1])
    window = _centered_window(win_length, n_fft, features.device)
    T = features.shape[-1]
    frames = torch.fft.irfft(features.transpose(-1, -2), n=n_fft) * window
    out = overlap_add(frames, hop_length)
    env = overlap_add((window**2)[None, None, :].expand(1, T, n_fft), hop_length)
    out = out / torch.where(env > 1e-11, env, torch.ones_like(env))
    pad = n_fft // 2
    out = out[..., pad:]
    if length is None:
        return out[..., : out.shape[-1] - pad]
    out = out[..., :length]
    if out.shape[-1] < length:
        out = F.pad(out, (0, length - out.shape[-1]))
    return out


def mag_phase(complex_tensor: torch.Tensor):
    """``(|X|, angle(X))``."""
    return complex_tensor.abs(), complex_tensor.angle()
