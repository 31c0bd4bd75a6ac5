"""The native ITU-T P.862.2 PESQ and composite measures (counterpart of
``se_tpu/eval/pesq_native.py``).

The port's own copy of the JAX package's C++ sources
(``se_tpu_torch/csrc/host/``) is built at first use by the host C++
compiler into ``build/host/`` (``ops/build.py``) and bound with ``ctypes``.
A failed build raises; nothing falls back to the numpy P.862.2
(``pesq_np.py``), which stays as the plain version the tests hold this one
to.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops.compile import load_host

SOURCES = ("pesq.cc", "composite.cc")

_DOUBLES = ctypes.POINTER(ctypes.c_double)


def load() -> ctypes.CDLL:
    """The library, built first if needed, with its entries declared."""
    lib = load_host("se_metrics", SOURCES)
    lib.pesq_measure_wb.restype = ctypes.c_double
    lib.pesq_measure_wb.argtypes = [_DOUBLES, _DOUBLES, ctypes.c_long, ctypes.c_long,
                                    ctypes.c_long]
    lib.composite_measures_c.restype = None
    lib.composite_measures_c.argtypes = [_DOUBLES, _DOUBLES, ctypes.c_long, ctypes.c_long,
                                         _DOUBLES]
    return lib


def _doubles(x) -> np.ndarray:
    a = np.ascontiguousarray(x, np.float64)
    if a.ndim != 1:
        raise ValueError(f"expected a 1-D waveform, got shape {a.shape}")
    return a


def pesq(clean: np.ndarray, degraded: np.ndarray, fs: int = 16000) -> float:
    """PESQ MOS-LQO of ``degraded`` against ``clean`` (the 16 kHz wideband
    model)."""
    lib = load()
    c, d = _doubles(clean), _doubles(degraded)
    return float(lib.pesq_measure_wb(c.ctypes.data_as(_DOUBLES), d.ctypes.data_as(_DOUBLES),
                                     len(c), len(d), fs))


def composite(clean: np.ndarray, processed: np.ndarray, fs: int) -> tuple:
    """``(CSIG, CBAK, COVL, segSNR)`` with the PESQ term at zero, both cut to
    the shorter length (``composite.composite_measures``)."""
    lib = load()
    n = min(len(clean), len(processed))
    c, p = _doubles(clean[:n]), _doubles(processed[:n])
    out = (ctypes.c_double * 4)()
    lib.composite_measures_c(c.ctypes.data_as(_DOUBLES), p.ctypes.data_as(_DOUBLES), n, fs, out)
    return tuple(out)
