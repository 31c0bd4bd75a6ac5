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
  dots-only    x . W_ih + h . W_hh, as a step of the wavefront probe (P2)
               forms layer 1's gates: ``csrc/gate_product.cuh``, CTAs of
               16 rows in clusters that share W's slabs by multicast

``run`` is the hand-written kernel ``csrc/vpu_probe.cu``; its result is
the op applied once to the tile, which ``reference`` computes.  ``main``
prints each op's time, its nanoseconds per element and its share of its
bound (:func:`bound_ms`: for the elementwise ops, their own MUFU and FP32
instructions, ``PIPE_COUNTS``, at their pipes' rates), and, at the same
volume, the time of the whole recurrence step (the bound probe's ``real``
mode, K2's cluster kernel).
"""

from __future__ import annotations

import ctypes
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import build
from . import bound_probe, cuda_ms, gate_product, sizes

BB, IN, H = 176, 32, 384  # one sub-band row tile; the sub band's first layer
OPS = ("sigmoid", "tanh", "0.5*tanh+0.5", "exp", "gates-only", "dots-only")
# H100 SXM: 67 TFLOP/s f32 is 128 FMA (256 FLOP) per clock on each of its
# SMs.  A clock of an SM runs 128 threads' FFMA, FADD or FMUL and 16
# results of the SFU (MUFU: exp2, rcp and the like; CUDA C++ Programming
# Guide, "Arithmetic Instructions", throughput table, compute capability
# 9.0)
PEAK_F32_FLOPS = 67e12
PIPE_RATES = {  # thread instructions a second on the card
    "FP32": PEAK_F32_FLOPS / 2,
    "MUFU": PEAK_F32_FLOPS * 16 / 256,
}
# The function's own instructions an element of each elementwise op:
# MUFU, and FP32 (FFMA, FADD, FMUL), read once from ``cuobjdump -sass
# build/kernels/libvpu_probe.so`` (the loop of vpu_probe_kernel<O>, on the
# path an element takes without the division's slow-path call), less the
# probe's own keep-chain FFMA; loads, addressing and loop control are the
# probe's cost, not the function's (PERF.md §6).  sigmoid_f32 is 1 / (1 +
# expf(-x)) without fast-math: ex2 and rcp; tanhf two; gates-only three
# sigmoids and two tanh.
PIPE_COUNTS = {
    "sigmoid": {"MUFU": 2, "FP32": 9},
    "tanh": {"MUFU": 2, "FP32": 9},
    "0.5*tanh+0.5": {"MUFU": 2, "FP32": 11},
    "exp": {"MUFU": 1, "FP32": 6},
    "gates-only": {"MUFU": 10, "FP32": 48},
}


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
        lib.se_vpu_dots_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        lib.se_vpu_dots_f32.restype = ctypes.c_int
    return lib


@dataclass(frozen=True)
class DotsPlan:
    """dots-only's tiling: the tile's ``tiles`` row tiles of 16 rows times
    ``groups`` groups of ``per`` steps (the last group fewer where groups
    does not divide the steps), one CTA each, in clusters of ``N``; a ring
    of ``stages`` W slabs; x padded to ``In_p`` rows k, the units to
    ``Hp``."""

    N: int
    stages: int
    groups: int
    per: int
    tiles: int
    clusters: int
    In_p: int
    Hp: int
    smem: int


def dots_plan(rows: int, In: int, n: int, steps: int) -> DotsPlan:
    """dots-only's tiling over ``steps`` repetitions of a tile of ``rows``
    rows, ``In`` inputs and ``n`` units: as many groups of steps as keep
    the launch in one wave of the clusters the card holds at once
    (``gate_product.CLUSTERS_AT_ONCE``), on the cluster size (4 or 2 CTAs)
    that leaves a CTA the fewest steps, the largest on a tie."""
    if rows < 1 or steps < 1:
        raise ValueError(f"rows and steps must be at least 1, got {rows}, {steps}")
    In_p, Hp = gate_product.padded(In, n)
    stages = gate_product.ring_stages(Hp, In_p + Hp)
    tiles = -(-rows // gate_product.TILE_ROWS)

    def groups(size):
        return max(1, min(steps, gate_product.CLUSTERS_AT_ONCE[size] * size // tiles))

    N = min(gate_product.CLUSTER_SIZES, key=lambda size: (-(-steps // groups(size)), -size))
    g = groups(N)
    return DotsPlan(N, stages, g, -(-steps // g), tiles, -(-tiles * g // N), In_p, Hp,
                    gate_product.smem_bytes(stages, Hp, In_p + Hp))


_NAMES = ("g", "c", "x", "h", "wih", "whh")


def run(op, g, c, x, h, wih, whh, steps=1, groups=1):
    """Same signature and result as :func:`reference` on one tile
    (``g [R, 4H]``, ``c``/``h [R, H]``, ``x [R, In]``, ``wih [In, 4H]``,
    ``whh [H, 4H]``).  CPU tensors run the plain version.  CUDA tensors
    launch the op's kernel over ``steps`` repetitions of the tile on the
    current stream, or raise: the elementwise ops in ``groups`` groups of
    steps (sigmoid and exp: H a multiple of 4), dots-only on
    :func:`dots_plan`'s tiling (H at most 384).  Each launch adds one to ``run.launches``."""
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
    if op == "dots-only":
        p = dots_plan(R, In, n, steps)
        for name, t in (("wih", wih), ("whh", whh)):
            if t.device != g.device or t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32 on {g.device}")
        w = gate_product.layout(((wih, p.In_p), (whh, p.Hp)), p.Hp)
        build.cuda_launch(_library(), "se_vpu_dots_f32", (x, h, w), ("x", "h", "w"), (out,),
                          (R, n, In, p.In_p, steps, p.groups, 0, p.N, p.stages), g.device)
    else:
        build.cuda_launch(_library(), "se_vpu_probe_f32", (g, c, x, h, wih, whh), _NAMES,
                          (out,), (R, n, In, steps, groups, OPS.index(op), 0), g.device)
    run.launches += 1
    return out


run.launches = 0


def dots_active_clusters(rows: int, In: int, n: int, steps: int, device=None) -> int:
    """How many clusters of :func:`dots_plan`'s tiling fit on the CUDA
    ``device`` at once (the runtime's occupancy query)."""
    p = dots_plan(rows, In, n, steps)
    return gate_product.active_clusters(_library(), "se_vpu_dots_active_clusters", In, n,
                                        p.In_p, p.N, p.stages, device)


def bound_ms(op, steps) -> float:
    """The least time of ``op`` over ``steps`` tiles: dots-only's FMAs at the
    f32 rate; an elementwise op's own instructions an element
    (``PIPE_COUNTS``) at the rate of the pipe they load most, MUFU or FP32
    (:func:`bound_pipe`)."""
    if op == "dots-only":
        return 1e3 * 2 * steps * BB * (IN + H) * 4 * H / PEAK_F32_FLOPS
    per = max(n / PIPE_RATES[pipe] for pipe, n in PIPE_COUNTS[op].items())
    return 1e3 * steps * BB * H * per


def bound_pipe(op) -> str:
    """The pipe that bounds an elementwise op: the larger of its times."""
    return max(PIPE_COUNTS[op], key=lambda pipe: PIPE_COUNTS[op][pipe] / PIPE_RATES[pipe])


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
            # the elementwise ops take less time than their launch's Python:
            # timed queued, the device's time
            ms = times[op] = cuda_ms(lambda: run(op, *data, steps=steps, groups=tiles), iters=5,
                                     queued=op != "dots-only")
            per = ms * 1e6 / (steps * BB * H)
            by = "FP32 FMA" if op == "dots-only" else bound_pipe(op)
            print(f"{op:14s}: {ms:8.4f} ms  ({per:.5f} ns/elem of [BB, H], "
                  f"{100 * bound_ms(op, steps) / ms:.1f}% of its bound, {by})  "
                  f"[{steps} steps of {BB} x {H}]")
        args = bound_probe.inputs(T, tiles * BB, IN, H, dev)
        times["recurrence"] = cuda_ms(lambda: bound_probe.run("real", *args), iters=5)
    print(f"sum of gates-only and dots-only: {times['gates-only'] + times['dots-only']:.4f} ms; "
          f"the recurrence at this volume (bound probe, real; T={T}, {tiles * BB} rows): "
          f"{times['recurrence']:.4f} ms")
    return times


if __name__ == "__main__":
    main()
