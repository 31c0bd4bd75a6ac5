"""The port's own tools that ask what bounds the recurrence on the card,
each a hand-written kernel with a plain PyTorch version:

- ``bound_probe`` (P1): the in-projection LSTM forward (K2's cluster design) with its
  per-step gate math swapped;
- ``wavefront_probe`` (P2): two stacked LSTM layers in one kernel, layer 2
  one step behind layer 1, against two K2 calls;
- ``vpu_probe`` (P3): the transcendentals, the LSTM cell's elementwise work
  and the two gate products alone, at the sub band's volume.

Run one on the card: ``python -m se_tpu_torch.probes.<name> [B] [T]``.
"""

from __future__ import annotations

import torch


def cuda_ms(fn, iters: int, warmup: int = 1, queued: bool = False) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``iters`` calls
    after ``warmup`` calls.  With ``queued`` the stream first spins for
    about half a millisecond a call, so that every call is queued before
    the first starts: the device's time alone, without the host's gaps
    between launches (for a kernel shorter than its wrapper's Python)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(1_000_000 * iters)  # clock cycles, ~1 GHz or faster
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def sizes(argv) -> tuple:
    """``(B, T)`` from ``[B] [T]``, defaults 32 and 193 as the JAX tools'."""
    B = int(argv[0]) if len(argv) > 0 else 32
    T = int(argv[1]) if len(argv) > 1 else 193
    return B, T
