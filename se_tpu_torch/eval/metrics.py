"""PESQ, STOI and SNR scoring (counterpart of ``se_tpu/eval/metrics.py``;
reference: tools_for_estimate.py).

The scorers run on the host.  A batch's utterances fan out over a process
pool that is made once per worker count and kept.  PESQ is the native
P.862.2 (``pesq_native.py``), as the JAX loop scores when its library
loads; it is built before the pool starts, so no worker compiles it.  The
numpy P.862.2 (``pesq_np.py``) is its plain version in the tests.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import List, Sequence

import numpy as np

from . import pesq_native
from .stoi import stoi as _stoi


def run_pesq_waveforms(dirty_wav: np.ndarray, clean_wav: np.ndarray, fs: int = 16000) -> float:
    """PESQ MOS-LQO of a degraded waveform against its clean reference
    (reference: tools_for_estimate.py:68-75)."""
    return pesq_native.pesq(np.asarray(clean_wav, np.float64),
                            np.asarray(dirty_wav, np.float64), fs)


def _pesq_one(args):
    dirty, clean, fs = args
    return run_pesq_waveforms(dirty, clean, fs)


def _stoi_one(args):
    est, clean, fs = args
    return _stoi(clean, est, fs, extended=False)


_POOLS: dict = {}


def _pool(workers: int) -> ProcessPoolExecutor:
    """The kept pool of ``workers`` processes.  Validation scores twice a
    batch (PESQ, then STOI); a new pool each time would pay the workers'
    start and imports every time.  ``concurrent.futures`` shuts the kept
    pools down at exit.  The workers are spawned, never forked: the trainer
    holds a CUDA context and threads, which a forked child must not
    inherit.  They import numpy and scipy only, and load the PESQ library
    the parent built."""
    ex = _POOLS.get(workers)
    if ex is None:
        ex = ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
        _POOLS[workers] = ex
    return ex


def _ready() -> None:
    """A worker's first task: unpickling it imports this module, and with it
    the scorers and scipy."""


def start_pool(workers: int) -> None:
    """Start the kept pool's ``workers`` processes now and return without
    waiting for them: each submitted task starts a worker, so a caller that
    scores later overlaps the workers' start (a fresh interpreter importing
    numpy and scipy) with its own work.  The PESQ library is built first."""
    pesq_native.load()
    if workers > 1:
        ex = _pool(workers)
        for _ in range(workers):
            ex.submit(_ready)


def _map(fn, jobs, workers: int | None):
    if not workers or workers <= 1 or len(jobs) <= 1:
        return [fn(j) for j in jobs]
    try:
        return list(_pool(workers).map(fn, jobs))
    except BrokenProcessPool:
        # a dead worker (an OOM kill) must not end scoring for the rest of a
        # run: make the pool once more, then score these jobs here
        _POOLS.pop(workers, None)
        try:
            return list(_pool(workers).map(fn, jobs))
        except BrokenProcessPool:
            _POOLS.pop(workers, None)
            return [fn(j) for j in jobs]


def cal_pesq(dirty_wavs: Sequence[np.ndarray], clean_wavs: Sequence[np.ndarray],
             fs: int = 16000, workers: int | None = None) -> List[float]:
    """PESQ of each pair (reference: tools_for_estimate.py:79-84), over
    ``workers`` processes when more than one."""
    pesq_native.load()
    return _map(_pesq_one, [(d, c, fs) for d, c in zip(dirty_wavs, clean_wavs)], workers)


def cal_stoi(estimated_speechs: Sequence[np.ndarray], clean_speechs: Sequence[np.ndarray],
             fs: int = 16000, workers: int | None = None) -> List[float]:
    """STOI of each pair (reference: tools_for_estimate.py:90-95), over
    ``workers`` processes when more than one."""
    return _map(_stoi_one, [(e, c, fs) for e, c in zip(estimated_speechs, clean_speechs)], workers)


def cal_snr(s1: np.ndarray, s2: np.ndarray, eps: float = 1e-8) -> float:
    """SNR of noisy ``s1`` given the signal ``s2`` (reference:
    tools_for_estimate.py:101-117); 100 where they are equal."""
    signal_diff = s2 - np.mean(s2)
    var_signal = np.sum(np.mean(signal_diff**2))
    noise = s1 - s2
    noise_diff = noise - np.mean(noise)
    var_noise = np.sum(np.mean(noise_diff**2))
    if var_noise == 0:
        return 100.0
    return float(10 * np.log10(var_signal / var_noise + eps))


def cal_snr_array(estimated_speechs, clean_speechs) -> List[float]:
    return [cal_snr(e, c) for e, c in zip(estimated_speechs, clean_speechs)]
