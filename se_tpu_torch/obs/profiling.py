"""Profiling hooks (counterpart of ``se_tpu/obs/profiling.py``): a device
trace and a step timer.

``device_trace`` records the host's and, where there is a card, the card's
activity with ``torch.profiler`` and writes a Chrome trace into ``logdir``
(open it in ui.perfetto.dev or chrome://tracing).  ``StepTimer`` keeps the
last and mean wall-clock time of the blocks it wraps; a block that launches
work on the card must end in ``torch.cuda.synchronize()`` for its time to
hold that work.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (CPU, and CUDA when available) and write
    its Chrome trace to ``logdir/trace_<pid>.json``; yields the profiler,
    whose ``key_averages()`` sum the time by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


class StepTimer:
    """Running mean and last wall-clock time of the wrapped blocks."""

    def __init__(self):
        self.n = 0
        self.total = 0.0
        self.last = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.last = time.perf_counter() - self._t0
        self.total += self.last
        self.n += 1
        return False

    @property
    def mean(self) -> float:
        return self.total / max(self.n, 1)
