"""The bound probe (P1): what bounds a step of the sub band's recurrence?

    python -m se_tpu_torch.probes.bound_probe [B] [T]

Counterpart of ``tools/bound_probe.py``.  It times the in-projection LSTM
forward kernel of K2's cluster design (``csrc/lstm_inproj.cu``, on K2's
cluster tiling, ``fused_lstm_inproj.cluster_tiling``) at the sub band's
first layer (B * 257 rows, In = 32, H = 384, T frames), with its per-step
gate math swapped at compile time:

  real       the LSTM's gate math: the very kernel K2 launches in that design
  bf16gates  gate pre-activations, exp, the sigmoid's sum and quotient, and
             tanh rounded to bf16; the carry stays f32
  polyswap   the transcendentals replaced by multiplies: the same slicing
             and elementwise volume, no transcendental
  nogates    no gate math: c and h straight from the raw gate slices

If polyswap times as real, the transcendentals do not bound the step; if
nogates times as real, neither does any of the elementwise work, and the
step is bound by its products and what they read.  As there, the inputs
are f32 (the JAX tool feeds bf16 x and writes bf16 ys; K2 takes f32 only).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ..ops import build
from ..ops.fused_lstm_inproj import cluster_tiling
from . import cuda_ms, sizes

MODES = ("real", "bf16gates", "polyswap", "nogates")
SUB_BAND = (257, 32, 384)  # rows per utterance, In, H of the sub band's first layer


def _cell(mode, gates, c):
    """One step's cell update of ``mode`` from the gate pre-activations."""
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    if mode == "real":
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        return torch.sigmoid(go) * torch.tanh(c), c
    if mode == "bf16gates":
        bf = torch.bfloat16

        def sig(v):
            return (1 / (1 + torch.exp(-v.to(bf)))).float()

        c = sig(gf) * c + sig(gi) * torch.tanh(gg.to(bf)).float()
        return sig(go) * torch.tanh(c.to(bf)).float(), c
    if mode == "polyswap":
        c = (gf * 0.25) * c + (gi * 0.25) * (gg * 0.5)
        return (go * 0.25) * (c * 0.5), c
    if mode == "nogates":
        return go, gf * c + gi
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def reference(mode, x, wih, b, whh, h0, c0):
    """The plain version of ``run``: ``x [T, Bb, In]``, ``wih [In, 4H]``,
    ``b [4H]``, ``whh [H, 4H]``, ``h0``/``c0 [Bb, H]`` -> ``(ys [T, Bb, H],
    hT, cT)``; gates ``(x[t] @ wih + h @ whh) + b`` in the order i, f, g, o."""
    h, c = h0, c0
    ys = []
    for t in range(x.shape[0]):
        h, c = _cell(mode, (x[t] @ wih + h @ whh) + b, c)
        ys.append(h)
    return torch.stack(ys), h, c


def _library():
    lib = build.load("lstm_inproj")
    if lib.se_lstm_inproj_probe_f32.argtypes is None:
        lib.se_lstm_inproj_probe_f32.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        )
        lib.se_lstm_inproj_probe_f32.restype = ctypes.c_int
    return lib


def run(mode, x, wih, b, whh, h0, c0):
    """Same signature and result as :func:`reference`.  CPU tensors run the
    plain version; CUDA tensors launch the probe kernel of ``mode`` on the
    current stream, or raise (float32, contiguous).  Each launch adds one
    to ``run.launches``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    T, Bb, In = x.shape
    H = whh.shape[0]
    want = {"wih": (In, 4 * H), "b": (4 * H,), "whh": (H, 4 * H), "h0": (Bb, H), "c0": (Bb, H)}
    for name, t in zip(want, (wih, b, whh, h0, c0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    if x.device.type == "cpu":
        return reference(mode, x, wih, b, whh, h0, c0)
    new = lambda *shape: torch.empty(shape, device=x.device, dtype=torch.float32)
    ys, hT, cT = new(T, Bb, H), new(Bb, H), new(Bb, H)
    build.cuda_launch(_library(), "se_lstm_inproj_probe_f32", (x, wih, b, whh, h0, c0),
                      ("x", "wih", "b", "whh", "h0", "c0"), (ys, hT, cT),
                      (T, Bb, In, H, MODES.index(mode), *cluster_tiling(Bb, In, H).args()),
                      x.device)
    run.launches += 1
    return ys, hT, cT


run.launches = 0


def inputs(T, Bb, In, H, device, seed=0):
    """The JAX tool's inputs: x 0.3 N(0, 1), weights 0.05 N(0, 1), zero bias
    and carries."""
    rng = np.random.default_rng(seed)
    host = (rng.standard_normal((T, Bb, In)) * 0.3, rng.standard_normal((In, 4 * H)) * 0.05,
            np.zeros(4 * H), rng.standard_normal((H, 4 * H)) * 0.05,
            np.zeros((Bb, H)), np.zeros((Bb, H)))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in host]


def main(argv=None) -> dict:
    """Times each mode on the card at the sub band's first layer for B
    utterances of T frames; returns ``{mode: ms}``."""
    from ..device import resolve_device

    B, T = sizes(sys.argv[1:] if argv is None else argv)
    per_utt, In, H = SUB_BAND
    Bb = B * per_utt
    args = inputs(T, Bb, In, H, resolve_device("cuda"))
    tiling = cluster_tiling(Bb, In, H)
    times = {}
    with torch.inference_mode():
        for mode in MODES:
            times[mode] = cuda_ms(lambda: run(mode, *args), iters=20)
            print(f"{mode:10s}: {times[mode]:8.4f} ms  ({times['real'] / times[mode]:.2f}x "
                  f"vs real)  [B={B} T={T} Bb={Bb} In={In} H={H}, {tiling}]")
    return times


if __name__ == "__main__":
    main()
