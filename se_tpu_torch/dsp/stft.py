"""Conv-STFT analysis and synthesis of DCCRN/CRN (counterpart of the
conv-STFT path of ``se_tpu/dsp/stft.py``).

The analysis is a framing plus one ``[win_len, fft_len + 2]`` product
with the windowed rFFT basis; the synthesis is the transposed product
with the basis' pseudo-inverse, an overlap-add, a division by the
overlap-added squared window and an edge trim.
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
