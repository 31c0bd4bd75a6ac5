"""STOI — short-time objective intelligibility (Taal et al., 2011): a copy
of ``se_tpu/eval/stoi.py``.

Vectorised numpy implementation numerically matched to pystoi 0.3.3, the
scorer the reference uses (reference: tools_for_estimate.py:90-95,
``extended=False``): octave-window resample to 10 kHz, energy-VAD
silent-frame removal, 1/3-octave band envelopes over 512-point STFTs,
384 ms segment correlations with clipped normalisation.

Two pystoi implementation quirks are reproduced on purpose (pinned by
tests/test_eval_metrics.py against the tests/oracles/pystoi_ref.py
restatement):

* frame ranges are EXCLUSIVE (``range(0, len - framelen, hop)``), so the
  final frame is dropped whenever ``(len - framelen) % hop == 0`` — which
  the STFT stage hits on every call, because silence removal returns a
  signal of exactly ``(n-1)*hop + framelen`` samples;
* resampling uses scipy ``resample_poly`` with pystoi's Octave-compatible
  Kaiser-windowed sinc filter, not scipy's default firwin design.

Only ``extended=False`` (what the reference calls) is parity-pinned; the
``extended=True`` branch follows the published ESTOI definition
deterministically (pystoi's adds ``standard_normal * eps`` dither).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
from scipy.signal import resample_poly

FS = 10000
N_FRAME = 256
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N = 30  # 384 ms segments
BETA = -15.0
DYN_RANGE = 40.0
EPS = float(np.finfo(np.float64).eps)


def _hann(n: int) -> np.ndarray:
    return np.hanning(n + 2)[1:-1]


@lru_cache(maxsize=8)
def _oct_window(p: int, q: int) -> np.ndarray:
    """Octave-compatible resample_poly filter (pystoi _resample_window_oct)."""
    g = np.gcd(p, q)
    p, q = p // g, q // g
    log10_rejection = -3.0
    stopband_cutoff_f = 1.0 / (2 * max(p, q))
    roll_off_width = stopband_cutoff_f / 10
    rejection_db = -20 * log10_rejection
    l = int(np.ceil((rejection_db - 8) / (28.714 * roll_off_width)))
    t = np.arange(-l, l + 1)
    ideal = 2 * p * stopband_cutoff_f * np.sinc(2 * stopband_cutoff_f * t)
    if 21 <= rejection_db <= 50:
        beta = 0.5842 * (rejection_db - 21) ** 0.4 + 0.07886 * (
            rejection_db - 21
        )
    elif rejection_db > 50:
        beta = 0.1102 * (rejection_db - 8.7)
    else:
        beta = 0.0
    h = np.kaiser(2 * l + 1, beta) * ideal
    return h / np.sum(h)


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    freq_low = min_freq * 2.0 ** ((2 * k - 1) / 6)
    freq_high = min_freq * 2.0 ** ((2 * k + 1) / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        fl_ii = np.argmin((f - freq_low[i]) ** 2)
        fh_ii = np.argmin((f - freq_high[i]) ** 2)
        obm[i, fl_ii:fh_ii] = 1
    return obm


_OBM = _thirdoct(FS, NFFT, NUMBAND, MINFREQ)


def _frames(x: np.ndarray, framelen: int, hop: int) -> np.ndarray:
    """pystoi's exclusive framing: starts ``range(0, len(x)-framelen, hop)``."""
    n = max(0, -(-(len(x) - framelen) // hop))
    idx = np.arange(framelen)[None, :] + hop * np.arange(n)[:, None]
    return x[idx] if n else np.zeros((0, framelen))


def _remove_silent_frames(x, y, dyn_range, framelen, hop):
    w = _hann(framelen)
    xf = _frames(x, framelen, hop) * w
    yf = _frames(y, framelen, hop) * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + EPS)
    mask = energies > np.max(energies) - dyn_range
    xf, yf = xf[mask], yf[mask]
    # overlap-add back to signals
    n = len(xf)
    x_sil = np.zeros((n - 1) * hop + framelen) if n else np.zeros(0)
    y_sil = np.zeros_like(x_sil)
    for i in range(n):
        x_sil[i * hop : i * hop + framelen] += xf[i]
        y_sil[i * hop : i * hop + framelen] += yf[i]
    return x_sil, y_sil


def _stft_mag(x: np.ndarray) -> np.ndarray:
    w = _hann(N_FRAME)
    f = _frames(x, N_FRAME, N_FRAME // 2) * w
    return np.abs(np.fft.rfft(f, n=NFFT, axis=-1))  # [T, F]


def stoi(x: np.ndarray, y: np.ndarray, fs_sig: int, extended: bool = False) -> float:
    """Compute STOI of degraded ``y`` against clean ``x``."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.shape != y.shape:
        raise ValueError("x and y must have the same length")
    if fs_sig != FS:
        g = np.gcd(FS, int(fs_sig))
        w = _oct_window(FS, int(fs_sig))
        x = resample_poly(x, FS // g, fs_sig // g, window=w)
        y = resample_poly(y, FS // g, fs_sig // g, window=w)

    if len(x) < N_FRAME + 1:
        return 1e-5  # degenerate: too short to frame (pystoi would crash)
    x, y = _remove_silent_frames(x, y, DYN_RANGE, N_FRAME, N_FRAME // 2)

    X = _stft_mag(x)  # [T, F]
    Y = _stft_mag(y)
    if X.shape[0] < N:
        return 1e-5

    # 1/3-octave band envelopes [T, J]
    Xb = np.sqrt((X**2) @ _OBM.T)
    Yb = np.sqrt((Y**2) @ _OBM.T)

    # [M, J, N] sliding segments ([J, M, N] views, batch axis first)
    xs = np.lib.stride_tricks.sliding_window_view(Xb.T, N, axis=1)
    ys = np.lib.stride_tricks.sliding_window_view(Yb.T, N, axis=1)
    xs = np.transpose(xs, (1, 0, 2)).copy()
    ys = np.transpose(ys, (1, 0, 2))

    if extended:
        xs_c = xs - xs.mean(axis=2, keepdims=True)
        ys_c = ys - ys.mean(axis=2, keepdims=True)
        xs_c /= np.linalg.norm(xs_c, axis=2, keepdims=True) + EPS
        ys_c /= np.linalg.norm(ys_c, axis=2, keepdims=True) + EPS
        xs_c -= xs_c.mean(axis=1, keepdims=True)
        ys_c -= ys_c.mean(axis=1, keepdims=True)
        xs_c /= np.linalg.norm(xs_c, axis=1, keepdims=True) + EPS
        ys_c /= np.linalg.norm(ys_c, axis=1, keepdims=True) + EPS
        return float(np.sum(xs_c * ys_c / N) / xs_c.shape[0])

    # normalise, clip (pystoi stoi.py, extended=False — EPS placement kept)
    alpha = np.linalg.norm(xs, axis=2, keepdims=True) / (
        np.linalg.norm(ys, axis=2, keepdims=True) + EPS
    )
    c = 10.0 ** (-BETA / 20.0)
    y_primes = np.minimum(ys * alpha, xs * (1 + c))
    y_primes = y_primes - y_primes.mean(axis=2, keepdims=True)
    xs = xs - xs.mean(axis=2, keepdims=True)
    y_primes /= np.linalg.norm(y_primes, axis=2, keepdims=True) + EPS
    xs /= np.linalg.norm(xs, axis=2, keepdims=True) + EPS
    M, J = xs.shape[0], xs.shape[1]
    return float(np.sum(xs * y_primes) / (J * M))
