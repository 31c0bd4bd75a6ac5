#!/usr/bin/env python3
"""Time the f32 forms of the hand kernels K1-K4, and K2's bf16-stream form,
and hash their outputs, to compare two checkouts on one card.

    (cd parent_checkout && python3 /path/to/kernels_ab.py parent)
    python3 kernels_ab.py change

Run it from the root of each checkout in turn, on one machine with an
NVIDIA H100, in the order parent, change, change, parent.  It builds that
checkout's kernels with its own ``chip_smoke.phase_build`` (which prints
each kernel's registers and spills), then times, with CUDA events, K1f at
DCCRN's enhance shape (T=483, L=2, Bb=16, H=128), K1b at its train shape
(Bb=20), K2f at CRN's enhance shape (T=483, Bb=8, In=512, H=128), K2b at
its train shape (Bb=10), K2f and K2b at DCCRN's real LSTM, both layers at
B=8 (T=483, Bb=8, In=1024 and 256, H=256) and at FullSubNet's four LSTM
layers at B=8 (T=163; full band Bb=8, In=257 and 512, H=512; sub band
Bb=2056, In=32 and 384, H=384), K3f and K3b at FullSubNet-GRU's sub band,
layer 0 at B=8 (T=163, Bb=2056, In=32, H=384), and K4 at the default
DCCRN's six encoder stages at B=8 (T=483), and last the bf16-stream forms
of K2f and K2b at FullSubNet's four LSTM layers, on inputs drawn from a
fixed seed.  It prints one line, ``AB
<tag> {kernel: [ms, sha256 of its outputs]}``: equal hashes mean equal bits.
"""

from __future__ import annotations

import hashlib
import json
import sys

sys.path.insert(0, ".")  # the checkout this runs from

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from se_tpu_torch.ops import fused_conv  # noqa: E402
from se_tpu_torch.ops import fused_gru_inproj as k3  # noqa: E402
from se_tpu_torch.ops import fused_lstm as k1  # noqa: E402
from se_tpu_torch.ops import fused_lstm_inproj as k2  # noqa: E402
from se_tpu_torch.probes import cuda_ms  # noqa: E402


# (label, T, Bb, In, H) of FullSubNet's four LSTM layers at B=8
FULLSUBNET_LSTM = (("fb l0", 163, 8, 257, 512), ("fb l1", 163, 8, 512, 512),
                   ("sb l0", 163, 2056, 32, 384), ("sb l1", 163, 2056, 384, 384))


def _hash(*tensors) -> str:
    m = hashlib.sha256()
    for t in tensors:
        m.update(t.detach().float().cpu().numpy().tobytes())
    return m.hexdigest()[:16]


def main(tag: str) -> dict:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: torch.cuda.is_available() is false")
    cs.phase_build()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    cots = lambda *shapes: [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
                            for s in shapes]
    out = {}
    T, L, H = 483, 2, 128
    for Bb, kind in ((16, "K1f"), (20, "K1b")):
        xp, w, h0, c0 = cs._scan_inputs(rng, dev, T, L, Bb, H)
        with torch.no_grad():
            ys, cs_, hT, cT = k1._forward(xp, w, h0, c0, need_cs=True)
            if kind == "K1f":
                ms = cuda_ms(lambda: k1.fused_lstm_scan(xp, w, h0, c0), 50, 3)
                out[kind] = (ms, _hash(ys, hT, cT))
            else:
                c = cots((T, L, Bb, H), (L, Bb, H), (L, Bb, H))
                g = k1.fused_lstm_scan_backward(xp, w, h0, c0, ys, cs_, *c)
                ms = cuda_ms(lambda: k1.fused_lstm_scan_backward(xp, w, h0, c0, ys, cs_, *c), 20, 2)
                out[kind] = (ms, _hash(*g))
    for label, T, Bb, In, H in (("CRN", 483, 8, 512, 128), ("CRN train", 483, 10, 512, 128),
                                ("DCCRN real l0", 483, 8, 1024, 256),
                                ("DCCRN real l1", 483, 8, 256, 256),
                                *FULLSUBNET_LSTM):
        args = cs._inproj_inputs(rng, dev, T, 1, Bb, In, H)
        with torch.no_grad():
            ys, cs_, hT, cT = k2._forward(*args, need_cs=True)
            c = cots((T, 1, Bb, H), (1, Bb, H), (1, Bb, H))
            if label != "CRN train":
                ms = cuda_ms(lambda: k2.fused_lstm_scan_inproj(*args), 10 if label == "CRN" else 5, 2)
                out[f"K2f {label}"] = (ms, _hash(ys, hT, cT))
            if label != "CRN":
                g = k2.fused_lstm_scan_inproj_backward(*args, ys, cs_, *c)
                ms = cuda_ms(lambda: k2.fused_lstm_scan_inproj_backward(*args, ys, cs_, *c),
                             10 if label == "CRN train" else 3, 1)
                out[f"K2b {label}"] = (ms, _hash(*g))
    T, Bb, In, H = 163, 2056, 32, 384
    args = cs._gru_inputs(rng, dev, T, 1, Bb, In, H)
    with torch.no_grad():
        ys, hT = k3.fused_gru_scan_inproj(*args)
        out["K3f sb l0"] = (cuda_ms(lambda: k3.fused_gru_scan_inproj(*args), 5, 2), _hash(ys, hT))
        c = cots((T, 1, Bb, H), (1, Bb, H))
        g = k3.fused_gru_scan_inproj_backward(*args, ys, *c)
        ms = cuda_ms(lambda: k3.fused_gru_scan_inproj_backward(*args, ys, *c), 3, 1)
        out["K3b sb l0"] = (ms, _hash(*g))
    for i, (C, Co, Fq) in enumerate(cs._CONV_STAGES):
        x, w, b = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            rng.standard_normal((16, C, Fq, 483)), rng.standard_normal((Co, C, 5, 2)) * 0.05,
            rng.standard_normal(Co))]
        with torch.no_grad():
            y = fused_conv.fused_complex_conv2d(x, w, b)
            ms = cuda_ms(lambda: fused_conv.fused_complex_conv2d(x, w, b), 20, 3)
        out[f"K4 stage {i + 1}"] = (ms, _hash(y))
    bf16 = torch.bfloat16
    for label, T, Bb, In, H in FULLSUBNET_LSTM:
        x, *rest = cs._inproj_inputs(rng, dev, T, 1, Bb, In, H)
        x = x.to(bf16)
        with torch.no_grad():
            ys, cs_, hT, cT = k2._forward(x, *rest, need_cs=True)
            ms = cuda_ms(lambda: k2.fused_lstm_scan_inproj(x, *rest), 5, 2)
            out[f"K2f-bf16 {label}"] = (ms, _hash(ys, hT, cT))
            dys, dhT, dcT = cots((T, 1, Bb, H), (1, Bb, H), (1, Bb, H))
            dys = dys.to(bf16)
            g = k2.fused_lstm_scan_inproj_backward(x, *rest, ys, cs_, dys, dhT, dcT)
            ms = cuda_ms(lambda: k2.fused_lstm_scan_inproj_backward(x, *rest, ys, cs_, dys, dhT,
                                                                    dcT), 3, 1)
            out[f"K2b-bf16 {label}"] = (ms, _hash(*g))
    print("AB", tag, json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
