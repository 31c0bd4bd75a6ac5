"""The wavefront probe (P2): does running two stacked LSTM layers in one
kernel, layer 2 one step behind layer 1, hide the latency of a step?

    python -m se_tpu_torch.probes.wavefront_probe [B] [T]

Counterpart of ``tools/wavefront_probe.py``.  ``wavefront_lstm2`` is the
hand-written kernel ``csrc/wavefront_lstm.cu``: iteration t forms layer 1's
gates of step t and layer 2's of step t - 1, then updates both cells, in
CTAs of 16 rows whose clusters share each slab of W by multicast
(``csrc/gate_product.cuh``); :func:`plan` picks the tiling.
``sequential_lstm2`` is what FullSubNet's sub band runs today, two calls of
the in-projection scan (K2); it is the probe's comparison.  ``reference``
is the plain version: two plain LSTM layers.  ``main`` checks the kernel
against the two K2 calls on a slice, then times both at the sub band's
shape (B * 257 rows, In = 32, H = 384, T frames).  Inputs are f32.
"""

from __future__ import annotations

import ctypes
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import build
from ..ops.fused_lstm_inproj import fused_lstm_scan_inproj, fused_lstm_scan_inproj_reference
from . import cuda_ms, gate_product, sizes
from .bound_probe import SUB_BAND

CHECK_TOL = 1e-4  # the JAX tool's own check, wavefront vs sequential


def _two_layers(scan, x, wih1, b1, whh1, wih2, b2, whh2, h0, c0):
    ys1, (h1, c1) = scan(x[:, None], wih1[None], b1[None], whh1[None], h0[:1], c0[:1])
    ys2, (h2, c2) = scan(ys1, wih2[None], b2[None], whh2[None], h0[1:], c0[1:])
    return ys2[:, 0], ys1[:, 0], torch.cat([h1, h2]), torch.cat([c1, c2])


def sequential_lstm2(x, wih1, b1, whh1, wih2, b2, whh2, h0, c0):
    """Two K2 calls: ``x [T, Bb, In]``, layer weights ``wih [In or H, 4H]``,
    ``b [4H]``, ``whh [H, 4H]``, ``h0``/``c0 [2, Bb, H]`` -> ``(ys2, ys1
    [T, Bb, H], hT, cT [2, Bb, H])``."""
    return _two_layers(fused_lstm_scan_inproj, x, wih1, b1, whh1, wih2, b2, whh2, h0, c0)


def reference(x, wih1, b1, whh1, wih2, b2, whh2, h0, c0):
    """The plain version: the same two layers as plain LSTMs."""
    return _two_layers(fused_lstm_scan_inproj_reference, x, wih1, b1, whh1, wih2, b2, whh2,
                       h0, c0)


@dataclass(frozen=True)
class Plan:
    """One launch's tiling: ``tiles`` row tiles of ``R`` rows, one a CTA,
    in ``clusters`` clusters of ``N`` CTAs (the last one's CTAs past the
    batch idle), ``waves`` waves of the clusters the card holds at once; a
    ring of ``stages`` W slabs; x padded to ``In_p`` rows k, the units to
    ``Hp``; ``smem`` bytes a CTA."""

    R: int
    N: int
    stages: int
    In_p: int
    Hp: int
    tiles: int
    clusters: int
    waves: int
    smem: int

    def args(self) -> tuple:
        """The entry's tiling arguments ``(In_p, N, stages)``."""
        return self.In_p, self.N, self.stages


def plan(Bb: int, In: int, H: int) -> Plan:
    """The tiling of a launch over ``Bb`` rows of ``In`` inputs and ``H``
    units: tiles of 16 rows; the cluster size (4 or 2 CTAs) whose launch
    runs in the fewest waves of the clusters the card
    holds at once (``gate_product.CLUSTERS_AT_ONCE``), the largest on a tie;
    the deepest ring that fits beside the two buffers [x; h1; h2].  Beyond
    one wave the rows' recurrences, being independent, run wave by wave."""
    if Bb < 1:
        raise ValueError(f"Bb must be at least 1, got {Bb}")
    In_p, Hp = gate_product.padded(In, H)
    buf_rows = In_p + 2 * Hp
    stages = gate_product.ring_stages(Hp, buf_rows)
    R = gate_product.TILE_ROWS
    tiles = -(-Bb // R)

    def waves(n):
        return -(-(-(-tiles // n)) // gate_product.CLUSTERS_AT_ONCE[n])

    N = min(gate_product.CLUSTER_SIZES, key=lambda n: (waves(n), -n))
    return Plan(R, N, stages, In_p, Hp, tiles, -(-tiles // N), waves(N),
                gate_product.smem_bytes(stages, Hp, buf_rows))


def layout(wih1, b1, whh1, wih2, b2, whh2, p: Plan) -> tuple:
    """``(w1 [In_p + Hp, 4 Hp], w2 [2 Hp, 4 Hp], bias [2, 4 Hp])``: the
    layers' weights and biases as the kernel reads them, unit-major
    columns (``gate_product.layout``)."""
    w1 = gate_product.layout(((wih1, p.In_p), (whh1, p.Hp)), p.Hp)
    w2 = gate_product.layout(((wih2, p.Hp), (whh2, p.Hp)), p.Hp)
    bias = gate_product.unit_major(torch.stack([b1, b2]).float(), p.Hp).contiguous()
    return w1, w2, bias


def _library():
    lib = build.load("wavefront_lstm")
    if lib.se_wavefront_lstm2_f32.argtypes is None:
        lib.se_wavefront_lstm2_f32.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        )
        lib.se_wavefront_lstm2_f32.restype = ctypes.c_int
    return lib


def active_clusters(Bb: int, In: int, H: int, device=None) -> int:
    """How many clusters of :func:`plan`'s tiling fit on the CUDA ``device``
    at once (the runtime's occupancy query)."""
    p = plan(Bb, In, H)
    return gate_product.active_clusters(_library(), "se_wavefront_active_clusters", In, H,
                                        *p.args(), device)


_NAMES = ("x", "wih1", "b1", "whh1", "wih2", "b2", "whh2", "h0", "c0")


def wavefront_lstm2(x, wih1, b1, whh1, wih2, b2, whh2, h0, c0):
    """Same signature and result as :func:`sequential_lstm2`.  CPU tensors
    run the plain version; CUDA tensors launch the wavefront kernel on the
    current stream on :func:`plan`'s tiling, or raise (float32, contiguous).  Each launch adds one to
    ``wavefront_lstm2.launches``."""
    args = (x, wih1, b1, whh1, wih2, b2, whh2, h0, c0)
    T, Bb, In = x.shape
    H = whh1.shape[0]
    G = 4 * H
    want = ((T, Bb, In), (In, G), (G,), (H, G), (H, G), (G,), (H, G), (2, Bb, H), (2, Bb, H))
    for name, t, shape in zip(_NAMES, args, want):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if x.device.type == "cpu":
        return reference(*args)
    p = plan(Bb, In, H)
    for name, t in zip(_NAMES, args):
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {x.device}, got {t.dtype} on {t.device}")
    w1, w2, bias = layout(wih1, b1, whh1, wih2, b2, whh2, p)
    new = lambda *shape: torch.empty(shape, device=x.device, dtype=torch.float32)
    ys2, ys1, hT, cT = new(T, Bb, H), new(T, Bb, H), new(2, Bb, H), new(2, Bb, H)
    build.cuda_launch(_library(), "se_wavefront_lstm2_f32", (x, w1, w2, bias, h0, c0),
                      ("x", "w1", "w2", "bias", "h0", "c0"), (ys2, ys1, hT, cT),
                      (T, Bb, In, H, *p.args()), x.device)
    wavefront_lstm2.launches += 1
    return ys2, ys1, hT, cT


wavefront_lstm2.launches = 0


def two_layer_inputs(T, Bb, In, H, device, seed=0):
    """The JAX tool's inputs: x 0.3 N(0, 1), weights 0.05 N(0, 1), zero
    biases and carries."""
    rng = np.random.default_rng(seed)
    G = 4 * H
    w = lambda k: rng.standard_normal((k, G)) * 0.05
    host = (rng.standard_normal((T, Bb, In)) * 0.3, w(In), np.zeros(G), w(H), w(H),
            np.zeros(G), w(H), np.zeros((2, Bb, H)), np.zeros((2, Bb, H)))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in host]


def main(argv=None) -> dict:
    """Checks the wavefront kernel against two K2 calls on the first 8
    frames of 512 rows, then times both on the card at the sub band's shape
    for B utterances of T frames; returns the times and the errors."""
    from ..device import resolve_device

    B, T = sizes(sys.argv[1:] if argv is None else argv)
    per_utt, In, H = SUB_BAND
    Bb = B * per_utt
    args = two_layer_inputs(T, Bb, In, H, resolve_device("cuda"))
    with torch.inference_mode():
        small = (args[0][:8, :512].contiguous(), *args[1:7],
                 args[7][:, :512].contiguous(), args[8][:, :512].contiguous())
        a, b = sequential_lstm2(*small), wavefront_lstm2(*small)
        err2 = (a[0] - b[0]).abs().max().item()
        err1 = (a[1] - b[1]).abs().max().item()
        print(f"max |ys2 diff| {err2:.2e}  |ys1 diff| {err1:.2e}")
        assert err2 < CHECK_TOL and err1 < CHECK_TOL, (err2, err1)
        ms_seq = cuda_ms(lambda: sequential_lstm2(*args), iters=10)
        ms_wav = cuda_ms(lambda: wavefront_lstm2(*args), iters=10)
    print(f"B={B} T={T} Bb={Bb}: sequential {ms_seq:.4f} ms | wavefront {ms_wav:.4f} ms | "
          f"speedup {ms_seq / ms_wav:.2f}x")
    return {"sequential_ms": ms_seq, "wavefront_ms": ms_wav, "ys2_err": err2, "ys1_err": err1}


if __name__ == "__main__":
    main()
