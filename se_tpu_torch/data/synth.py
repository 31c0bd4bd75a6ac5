"""On-the-fly mixing (counterpart of ``mix_at_snr`` in ``se_tpu/data/synth.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def mix_at_snr(
    clean: np.ndarray,
    noise: np.ndarray,
    snr_db: float,
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mix a random crop of ``noise`` into ``clean`` at ``snr_db`` ->
    ``(noisy, clean)``, the reference's mixing: a random crop (the noise
    tiled when it is not longer than the speech), each signal's mean
    removed, and the noise scaled by ``sqrt(10**(-snr/10) * Ps / Pn)``."""
    rng = rng or np.random.default_rng()
    if len(noise) <= len(clean):
        reps = -(-len(clean) // len(noise)) + 1
        noise = np.tile(noise, reps)
    start = rng.integers(0, len(noise) - len(clean))
    noise_seg = noise[start : start + len(clean)]

    clean = clean - np.mean(clean)
    noise_seg = noise_seg - np.mean(noise_seg)
    p_speech = np.mean(clean**2)
    p_noise = np.mean(noise_seg**2) + 1e-20
    alpha = np.sqrt(10.0 ** (-snr_db / 10.0) * p_speech / p_noise)
    return clean + alpha * noise_seg, clean
