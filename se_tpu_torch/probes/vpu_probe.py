"""The elementwise-throughput probe (P3): what do a step's transcendentals,
its cell update and its two gate products cost on the card when nothing
waits on anything?

    python -m se_tpu_torch.probes.vpu_probe [B] [T]

Counterpart of ``tools/vpu_probe.py``.  Six ops over one sub-band row tile
(BB = 176 rows, H = 384, In = 32), each repeated for the sub band's volume
at B utterances of T frames, ``steps = T * ceil(B * 257 / BB)`` times:

  sigmoid, tanh, 0.5 * tanh(v / 2) + 0.5, exp   of g[:, :H]
  gates-only   the LSTM cell's elementwise work on (g, c): the scan's
               cell_forward
  dots-only    x . W_ih + h . W_hh, as a scan step forms its gates (4 rows
               a block, W from L2)

``run`` is the hand-written kernel ``csrc/vpu_probe.cu``; its result is
the op applied once to the tile, which ``reference`` computes.  ``main``
prints each op's time, its nanoseconds per element and its share of the
card's rate, and, at the same volume, the time of the whole recurrence
step (the bound probe's ``real`` mode, the kernel K2 runs).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ..ops import build
from . import bound_probe, cuda_ms, sizes

BB, IN, H = 176, 32, 384  # one sub-band row tile; the sub band's first layer
OPS = ("sigmoid", "tanh", "0.5*tanh+0.5", "exp", "gates-only", "dots-only")
# transcendentals per element: the op's count at one SFU instruction each
# (a sigmoid as one tanh); gates-only has three sigmoids and two tanh
TRANSCENDENTALS = {"sigmoid": 1, "tanh": 1, "0.5*tanh+0.5": 1, "exp": 1, "gates-only": 5}
# H100 SXM: 67 TFLOP/s f32 is 128 FMA (256 FLOP) per clock on each of its
# SMs; the SFU gives 16 results of exp2, rcp and the like per clock on each
# SM at compute capability 9.0 (CUDA C++ Programming Guide, "Arithmetic
# Instructions", throughput table), so 67e12 * 16 / 256 a second
PEAK_F32_FLOPS = 67e12
PEAK_SFU_PER_S = PEAK_F32_FLOPS * 16 / 256


def tile(device, seed=0):
    """``(g [BB, 4H], c [BB, H], x [BB, In], h [BB, H], w_ih [In, 4H],
    w_hh [H, 4H])``: N(0, 1), the weights 0.05 N(0, 1), as the JAX tool's."""
    rng = np.random.default_rng(seed)
    host = (rng.standard_normal((BB, 4 * H)), rng.standard_normal((BB, H)),
            rng.standard_normal((BB, IN)), rng.standard_normal((BB, H)),
            rng.standard_normal((IN, 4 * H)) * 0.05, rng.standard_normal((H, 4 * H)) * 0.05)
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in host]


def reference(op, g, c, x, h, wih, whh):
    """The plain version: ``op`` applied once to the tile (any leading
    dimensions broadcast)."""
    n = c.shape[-1]
    v = g[..., :n]
    if op == "sigmoid":
        return torch.sigmoid(v)
    if op == "tanh":
        return torch.tanh(v)
    if op == "0.5*tanh+0.5":
        return 0.5 * torch.tanh(v * 0.5) + 0.5
    if op == "exp":
        return torch.exp(v)
    if op == "gates-only":
        gi, gf, gg, go = g.chunk(4, dim=-1)
        cn = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        return torch.sigmoid(go) * torch.tanh(cn)
    if op == "dots-only":
        return x @ wih + h @ whh
    raise ValueError(f"op must be one of {OPS}, got {op!r}")


def _library():
    lib = build.load("vpu_probe")
    if lib.se_vpu_probe_f32.argtypes is None:
        lib.se_vpu_probe_f32.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.se_vpu_probe_f32.restype = ctypes.c_int
    return lib


_NAMES = ("g", "c", "x", "h", "wih", "whh")


def run(op, g, c, x, h, wih, whh, steps=1, groups=1):
    """Same signature and result as :func:`reference` on one tile
    (``g [R, 4H]``, ``c``/``h [R, H]``, ``x [R, In]``, ``wih [In, 4H]``,
    ``whh [H, 4H]``; In and H at most 512).  CPU tensors run the plain
    version.  CUDA tensors launch the op's kernel over ``steps``
    repetitions of the tile (the elementwise ops in ``groups`` groups of
    steps) on the current stream, or raise.  Each launch adds one to
    ``run.launches``."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    R, G = g.shape
    n, In = G // 4, x.shape[1]
    want = ((R, G), (R, n), (R, In), (R, n), (In, G), (n, G))
    for name, t, shape in zip(_NAMES, (g, c, x, h, wih, whh), want):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if g.device.type == "cpu":
        return reference(op, g, c, x, h, wih, whh)
    out = torch.empty((R, G if op == "dots-only" else n), device=g.device, dtype=torch.float32)
    build.cuda_launch(_library(), "se_vpu_probe_f32", (g, c, x, h, wih, whh), _NAMES, (out,),
                      (R, n, In, steps, groups, OPS.index(op), 0), g.device)
    run.launches += 1
    return out


run.launches = 0


def bound_ms(op, steps) -> float:
    """The least time of ``op`` over ``steps`` tiles: its transcendentals at
    the SFU's rate, or dots-only's FMAs at the f32 rate."""
    if op == "dots-only":
        return 1e3 * 2 * steps * BB * (IN + H) * 4 * H / PEAK_F32_FLOPS
    return 1e3 * steps * BB * H * TRANSCENDENTALS[op] / PEAK_SFU_PER_S


def main(argv=None) -> dict:
    """Times each op on the card at the sub band's volume for B utterances
    of T frames, then the bound probe's ``real`` mode on the same volume;
    returns ``{op: ms}`` and that time under ``"recurrence"``."""
    from ..device import resolve_device

    B, T = sizes(sys.argv[1:] if argv is None else argv)
    dev = resolve_device("cuda")
    tiles = -(-B * 257 // BB)
    steps = T * tiles
    data = tile(dev)
    times = {}
    with torch.inference_mode():
        for op in OPS:
            ms = times[op] = cuda_ms(lambda: run(op, *data, steps=steps, groups=tiles), iters=5)
            per = ms * 1e6 / (steps * BB * H)
            print(f"{op:14s}: {ms:8.4f} ms  ({per:.5f} ns/elem of [BB, H], "
                  f"{100 * bound_ms(op, steps) / ms:.1f}% of the card's rate)  "
                  f"[{steps} steps of {BB} x {H}]")
        args = bound_probe.inputs(T, tiles * BB, IN, H, dev)
        times["recurrence"] = cuda_ms(lambda: bound_probe.run("real", *args), iters=5)
    print(f"sum of gates-only and dots-only: {times['gates-only'] + times['dots-only']:.4f} ms; "
          f"the recurrence at this volume (bound probe, real; T={T}, {tiles * BB} rows): "
          f"{times['recurrence']:.4f} ms")
    return times


if __name__ == "__main__":
    main()
