"""WAV I/O (counterpart of ``read_wav``/``write_wav`` in ``se_tpu/data/synth.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def read_wav(path: str, target_fs: int | None = None) -> Tuple[np.ndarray, int]:
    """Read a wav as float64 in [-1, 1], mixed down to mono and resampled
    to ``target_fs`` when given."""
    fs, x = wavfile.read(path)
    if x.dtype == np.int16:
        x = x.astype(np.float64) / 32768.0
    elif x.dtype == np.int32:
        x = x.astype(np.float64) / 2147483648.0
    elif x.dtype == np.uint8:
        x = (x.astype(np.float64) - 128.0) / 128.0
    else:
        x = x.astype(np.float64)
    if x.ndim > 1:
        x = x.mean(axis=1)
    if target_fs is not None and fs != target_fs:
        g = np.gcd(int(target_fs), int(fs))
        x = resample_poly(x, target_fs // g, fs // g)
        fs = target_fs
    return x, fs


def write_wav(path: str, x: np.ndarray, fs: int):
    """int16 write with the reference's x32768 scaling, saturating at full
    scale where the reference's bare cast wraps."""
    wavfile.write(path, fs, np.clip(x * 32768, -32768, 32767).astype(np.int16))
