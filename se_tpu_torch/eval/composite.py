"""Composite objective measures: WSS, LLR, segSNR and the CSIG/CBAK/COVL
regressions of Hu & Loizou (2006) (counterpart of
``se_tpu/eval/composite.py``; reference: composite.m:151-562, run through
Octave by tools_for_estimate.py:19-30).

A quirk kept from the reference: the regressions are computed and clamped
to [1, 5] with the PESQ term at zero, and the caller adds the PESQ-weighted
terms afterwards (composite.m:79-89, tools_for_estimate.py:27-29), so the
final values can exceed 5.  ``composite_measures`` runs the native C++ form
(``csrc/host/composite.cc`` through ``pesq_native.py``); the numpy form
here is its plain version.
"""

from __future__ import annotations

import numpy as np

from . import pesq_native

# WSS critical band geometry (composite.m:191-215)
_CENT_FREQ = np.array([
    50.0, 120.0, 190.0, 260.0, 330.0, 400.0, 470.0, 540.0, 617.372,
    703.378, 798.717, 904.128, 1020.38, 1148.30, 1288.72, 1442.54,
    1610.70, 1794.16, 1993.93, 2211.08, 2446.71, 2701.97, 2978.04,
    3276.17, 3597.63,
])
_BANDWIDTH = np.array([
    70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 77.3724, 86.0056, 95.3398,
    105.411, 116.256, 127.914, 140.423, 153.823, 168.154, 183.457,
    199.776, 217.153, 235.631, 255.255, 276.072, 298.126, 321.465,
    346.136,
])


def _window(n: int) -> np.ndarray:
    """0.5 (1 - cos(2 pi k / (N+1))), k = 1..N (composite.m:245)."""
    k = np.arange(1, n + 1)
    return 0.5 * (1 - np.cos(2.0 * np.pi * k / (n + 1)))


def _framing(x: np.ndarray, winlength: int, skiprate: int) -> np.ndarray:
    num_frames = int(len(x) / skiprate - winlength / skiprate)
    idx = np.arange(winlength)[None, :] + skiprate * np.arange(num_frames)[:, None]
    return x[idx] * _window(winlength)[None, :]


def wss(clean: np.ndarray, processed: np.ndarray, fs: int) -> np.ndarray:
    """Weighted spectral slope distance per frame (composite.m:151-382)."""
    winlength = round(30 * fs / 1000)
    skiprate = winlength // 4
    max_freq = fs / 2
    num_crit = 25
    n_fft = 2 ** int(np.ceil(np.log2(2 * winlength)))
    n_fftby2 = n_fft // 2
    Kmax, Klocmax = 20.0, 1.0

    min_factor = np.exp(-30.0 / (2.0 * 2.303))
    j = np.arange(n_fftby2)
    f0 = np.floor(_CENT_FREQ / max_freq * n_fftby2)
    bw = _BANDWIDTH / max_freq * n_fftby2
    norm = np.log(_BANDWIDTH[0]) - np.log(_BANDWIDTH)
    crit_filter = np.exp(
        -11.0 * ((j[None, :] - f0[:, None]) / bw[:, None]) ** 2 + norm[:, None]
    )
    crit_filter *= crit_filter > min_factor  # [25, n_fftby2]

    cf = _framing(clean, winlength, skiprate)
    pf = _framing(processed, winlength, skiprate)
    cspec = np.abs(np.fft.fft(cf, n_fft, axis=1)) ** 2
    pspec = np.abs(np.fft.fft(pf, n_fft, axis=1)) ** 2

    ce = 10 * np.log10(np.maximum(cspec[:, :n_fftby2] @ crit_filter.T, 1e-10))
    pe = 10 * np.log10(np.maximum(pspec[:, :n_fftby2] @ crit_filter.T, 1e-10))

    cs = ce[:, 1:] - ce[:, :-1]  # slopes [T, 24]
    ps = pe[:, 1:] - pe[:, :-1]

    def loc_peaks(energy, slope):
        """Nearest local peak per band (composite.m:305-339).

        The right search reproduces the reference exactly: composite.m:314
        takes ``clean_energy(n-1)`` at loop exit — one band BELOW the local
        maximum (0-based ``e[n-1]`` here) — not the maximum itself.  Pinned
        by tests/oracles/octave_composite.py.
        """
        T = energy.shape[0]
        out = np.empty((T, num_crit - 1))
        for t in range(T):
            e, s = energy[t], slope[t]
            for i in range(num_crit - 1):
                n = i
                if s[i] > 0:
                    while n < num_crit - 1 and s[n] > 0:
                        n += 1
                    out[t, i] = e[n - 1]
                else:
                    while n >= 0 and s[n] <= 0:
                        n -= 1
                    out[t, i] = e[n + 1]
        return out

    clp = loc_peaks(ce, cs)
    plp = loc_peaks(pe, ps)

    dbmax_c = ce.max(axis=1, keepdims=True)
    dbmax_p = pe.max(axis=1, keepdims=True)
    Wc = (Kmax / (Kmax + dbmax_c - ce[:, :-1])) * (
        Klocmax / (Klocmax + clp - ce[:, :-1])
    )
    Wp = (Kmax / (Kmax + dbmax_p - pe[:, :-1])) * (
        Klocmax / (Klocmax + plp - pe[:, :-1])
    )
    W = (Wc + Wp) / 2.0
    dist = np.sum(W * (cs - ps) ** 2, axis=1) / np.sum(W, axis=1)
    return dist


def _lpcoeff(frames: np.ndarray, order: int):
    """Autocorrelation + Levinson-Durbin per frame (composite.m:458-487).

    Returns (R [T, order+1], A [T, order+1]) with A = [1, -a].
    """
    T, N = frames.shape
    R = np.empty((T, order + 1))
    for k in range(order + 1):
        R[:, k] = np.sum(frames[:, : N - k] * frames[:, k:], axis=1)

    A = np.empty((T, order + 1))
    for t in range(T):
        r = R[t]
        a = np.zeros(order)
        E = r[0]
        for i in range(order):
            acc = np.sum(a[:i] * r[i:0:-1]) if i > 0 else 0.0
            rc = (r[i + 1] - acc) / E
            a_new = a.copy()
            a_new[i] = rc
            if i > 0:
                a_new[:i] = a[:i] - rc * a[:i][::-1]
            a = a_new
            E = (1 - rc * rc) * E
        A[t, 0] = 1.0
        A[t, 1:] = -a
    return R, A


def llr(clean: np.ndarray, processed: np.ndarray, fs: int) -> np.ndarray:
    """Log-likelihood ratio per frame (composite.m:385-455)."""
    winlength = round(30 * fs / 1000)
    skiprate = winlength // 4
    order = 10 if fs < 10000 else 16

    cf = _framing(clean, winlength, skiprate)
    pf = _framing(processed, winlength, skiprate)
    Rc, Ac = _lpcoeff(cf, order)
    _, Ap = _lpcoeff(pf, order)

    T = cf.shape[0]
    dist = np.empty(T)
    for t in range(T):
        # A @ toeplitz(R) @ A' without forming the matrix:
        # sum_k sum_l A_k A_l R[|k-l|]
        toep = _toeplitz(Rc[t])
        num = Ap[t] @ toep @ Ap[t]
        den = Ac[t] @ toep @ Ac[t]
        dist[t] = np.log(num / den)
    return dist


def _toeplitz(r: np.ndarray) -> np.ndarray:
    n = len(r)
    idx = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    return r[idx]


def snr_measures(clean: np.ndarray, processed: np.ndarray, fs: int):
    """Overall + clamped segmental SNR (composite.m:492-562)."""
    overall = 10 * np.log10(
        np.sum(clean**2) / np.sum((clean - processed) ** 2)
    )
    winlength = round(30 * fs / 1000)
    skiprate = winlength // 4
    cf = _framing(clean, winlength, skiprate)
    pf = _framing(processed, winlength, skiprate)
    eps = np.finfo(np.float64).eps
    sig = np.sum(cf**2, axis=1)
    noise = np.sum((cf - pf) ** 2, axis=1)
    seg = 10 * np.log10(sig / (noise + eps) + eps)
    return overall, np.clip(seg, -10.0, 35.0)


def composite_measures(clean: np.ndarray, processed: np.ndarray, fs: int,
                       native: bool = True):
    """CSIG/CBAK/COVL (pesq term zero, clamped) + mean segSNR
    (composite.m:40-89); through the native library unless ``native`` is
    False (the numpy form below, the plain version it is held to)."""
    if native:
        return pesq_native.composite(clean, processed, fs)
    eps = np.finfo(np.float64).eps
    n = min(len(clean), len(processed))
    clean = clean[:n] + eps
    processed = processed[:n] + eps
    alpha = 0.95

    # MATLAB round() is half-away-from-zero (floor(x+0.5) for positive),
    # not Python banker's rounding (composite.m:61,:67).
    def _mround(x: float) -> int:
        return int(np.floor(x + 0.5))

    wss_vec = np.sort(wss(clean, processed, fs))
    wss_dist = np.mean(wss_vec[: _mround(len(wss_vec) * alpha)])

    llr_vec = np.sort(llr(clean, processed, fs))
    llr_mean = np.mean(llr_vec[: _mround(len(llr_vec) * alpha)])

    _, seg = snr_measures(clean, processed, fs)
    seg_snr = float(np.mean(seg))

    pesq_mos = 0.0  # re-added by the caller (tools_for_estimate.py:27-29)
    csig = 3.093 - 1.029 * llr_mean + 0.603 * pesq_mos - 0.009 * wss_dist
    csig = float(np.clip(csig, 1, 5))
    cbak = 1.634 + 0.478 * pesq_mos - 0.007 * wss_dist + 0.063 * seg_snr
    cbak = float(np.clip(cbak, 1, 5))
    covl = 1.594 + 0.805 * pesq_mos - 0.512 * llr_mean - 0.007 * wss_dist
    covl = float(np.clip(covl, 1, 5))
    return csig, cbak, covl, seg_snr
