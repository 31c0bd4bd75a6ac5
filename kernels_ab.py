#!/usr/bin/env python3
"""Time the hand kernels K1-K4 in both forms (f32 and bf16) and the probes
P1-P3, and hash their outputs, to compare two checkouts on one card.

    (cd parent_checkout && python3 /path/to/kernels_ab.py parent [families])
    python3 kernels_ab.py change [families]

Run it from the root of each checkout in turn, on one machine with an
NVIDIA H100, in the order parent, change, change, parent.  It builds that
checkout's kernels with its own ``chip_smoke.phase_build`` (which prints
each kernel's registers and spills), then times, with CUDA events, K1f at
DCCRN's enhance shape (T=483, L=2, Bb=16, H=128) and K1b at its train shape
(Bb=20), f32 then bf16, each beside cuDNN's ``nn.LSTM`` in the same dtype
and, where the checkout's K1 has a plan (``fused_lstm.plan``), in every
tiling forced: clusters of N = 2, 4, 8 or 16 CTAs with tiles of up to R =
4, 8, 16 or 20 rows (``[N=.. R=..]`` keys); then K2f at CRN's enhance
shape (T=483, Bb=8, In=512, H=128), K2b at its train shape (Bb=10), K2f
and K2b at DCCRN's real LSTM, both layers at
B=8 (T=483, Bb=8, In=1024 and 256, H=256) and at FullSubNet's four LSTM
layers at B=8 (T=163; full band Bb=8, In=257 and 512, H=512; sub band
Bb=2056, In=32 and 384, H=384), K4 at the default DCCRN's six encoder
stages at B=8 (T=483) in both forms, each beside one cuDNN conv in the
same dtype, P1 (its four gate modes at T=163 and 1028 rows of the sub
band's first layer), the bf16-stream forms of K2f and K2b at FullSubNet's
four LSTM layers, K2f and K2b with the bf16 cell-state stash and with the
f32 one at FullSubNet's four LSTM layers (family ``K2-cs16``, which a
parent without the stash lacks), and last K3f and K3b, f32 then bf16, at
FullSubNet-GRU's four layers (the same shapes) and its sub band at B=10
(Bb=2570), then the wavefront probe
P2 (and the two K2 calls it is compared with) at the sub band's two
layers at B=8 and P3's dots-only at 1956 steps of its 176 x 384 tile, on
inputs drawn from a fixed seed.  Beside K3 at each layer it times cuDNN's
``nn.GRU`` in the same dtype (``cuDNN ...`` keys: the forward, and forward + backward minus
forward), and beside K2-bf16 at the two l1 layers cuDNN's bf16
``nn.LSTM`` and the plain versions.  It prints one line, ``AB <tag>
{kernel: [ms, sha256 of its outputs or null]}``: equal hashes mean equal
bits; then ``LAUNCHES <tag> {layer: [[kernel, us], ...]}``, each launch
of one f32 K3b call at each layer and of one K2b call at the sub band's
two layers (``K2b sb l0`` ...) in order (torch.profiler, the least of
three calls), and each design of the checkout's K3 forced at each layer
and form, its time and hash under ``K3f ... [cluster]``, ``[block]`` and,
where the checkout has it, ``[wave]`` keys.  The family ``K3-sweep`` times
K3f and K3b in the per-block and the wave design at every sub-band shape
the paths launch (B = 1 to 10, a stream's chunk, the ragged H = 64 case;
``K3_SWEEP``) beside the design the planner takes there.
Beside K2 at FullSubNet's four layers it times each design of the
checkout's K2 forced (``[cluster]``, and ``[wave]`` at H = 384, where the
checkout has the wave design), and the family ``K2-sweep`` times K2f and
K2b in both designs at every sub-band shape (B = 1 to 10, a stream's
chunk; ``K2_SWEEP``) beside the design the planner takes there.
``families`` (comma-separated, of ``FAMILIES``) limits the run to those;
each family draws its inputs from its own generator, so a family's
hashes are the same in a run of some families as in a run of all.
It calls the wrappers' public functions only, so this one script, run from
the root of a parent checkout, times the parent's kernels.
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


FAMILIES = ("K1", "K2", "K4", "P1", "K2-bf16", "K3", "P2", "P3", "K2-cs16", "K3-sweep",
            "K2-sweep")


def main(tag: str, only: str = "") -> dict:
    """Times and hashes every family of ``FAMILIES``, or those named in
    ``only`` (comma-separated)."""
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: torch.cuda.is_available() is false")
    wanted = set(only.split(",")) if only else set(FAMILIES)
    if wanted - set(FAMILIES):
        sys.exit(f"unknown families {sorted(wanted - set(FAMILIES))}; known: {FAMILIES}")
    cs.phase_build()
    from se_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")  # TF32 off, cuDNN's RNNs too, as in chip_smoke.py

    def draws(family):
        rng = np.random.default_rng((0, FAMILIES.index(family)))
        cots = lambda *shapes: [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                                .to(dev) for s in shapes]
        return rng, cots

    out = {}
    launches = {}
    for family, run in (("K1", _k1), ("K2", _k2), ("K4", _k4), ("P1", _p1),
                        ("K2-bf16", _k2_bf16), ("K2-cs16", _k2_cs16), ("K3", _k3), ("P2", _p2),
                        ("P3", _p3), ("K3-sweep", _k3_sweep), ("K2-sweep", _k2_sweep)):
        if family in wanted:
            launches.update(run(*draws(family), dev, out) or {})
    print("AB", tag, json.dumps(out))
    print("LAUNCHES", tag, json.dumps(launches))
    return out


# K1's tilings: (CTAs a cluster, rows a cluster at most)
K1_TILES = tuple((N, R) for N in (2, 4, 8, 16) for R in (4, 8, 16, 20))


def _k2_designs() -> dict:
    """``{key suffix: planner}``: the checkout's own K2 plan (``""``) and,
    where the checkout has two designs (``fused_lstm_inproj.wave_plan``),
    each forced: ``[cluster]`` (``cluster_tiling``) and ``[wave]``."""
    planner = k2.plan
    designs = {"": planner}
    if hasattr(k2, "wave_plan"):
        designs[" [cluster]"] = lambda Bb, In, H, backward=False, L=1: k2.cluster_tiling(
            Bb, In, H, backward)
        designs[" [wave]"] = lambda Bb, In, H, backward=False, L=1: k2.wave_plan(
            Bb, In, H, backward, L)
    return designs


def _k2(rng, cots, dev, out) -> dict:
    """K2f and K2b at CRN, DCCRN's real LSTM and FullSubNet's four layers,
    the last also in each design forced (``_k2_designs``; the wave design
    only at H <= 384); returns each launch of one K2b call in the
    checkout's design at the sub band's two layers (``K2b sb l0`` ...)."""
    designs = _k2_designs()
    launches = {}
    try:
        for label, T, Bb, In, H in (("CRN", 483, 8, 512, 128), ("CRN train", 483, 10, 512, 128),
                                    ("DCCRN real l0", 483, 8, 1024, 256),
                                    ("DCCRN real l1", 483, 8, 256, 256),
                                    *FULLSUBNET_LSTM):
            args = cs._inproj_inputs(rng, dev, T, 1, Bb, In, H)
            c = cots((T, 1, Bb, H), (1, Bb, H), (1, Bb, H))
            for suffix, design in designs.items():
                if suffix and (label.startswith(("CRN", "DCCRN")) or
                               (suffix == " [wave]" and H > 384)):
                    continue
                k2.plan = design
                with torch.no_grad():
                    ys, cs_, hT, cT = k2._forward(*args, need_cs=True)
                    if label != "CRN train":
                        ms = cuda_ms(lambda: k2.fused_lstm_scan_inproj(*args),
                                     10 if label == "CRN" else 5, 2)
                        out[f"K2f {label}{suffix}"] = (ms, _hash(ys, hT, cT))
                    if label != "CRN":
                        g = k2.fused_lstm_scan_inproj_backward(*args, ys, cs_, *c)
                        ms = cuda_ms(lambda: k2.fused_lstm_scan_inproj_backward(*args, ys, cs_, *c),
                                     10 if label == "CRN train" else 3, 1)
                        out[f"K2b {label}{suffix}"] = (ms, _hash(*g))
                        if suffix == "" and label.startswith("sb"):
                            launches[f"K2b {label}"] = _kernel_launches(
                                lambda: k2.fused_lstm_scan_inproj_backward(*args, ys, cs_, *c))
                        del g
                    del ys, cs_
            k2.plan = designs[""]
    finally:
        k2.plan = designs[""]
    return launches


# Every K2 shape of FullSubNet's sub band where the two designs compete (T,
# Bb, In, H; backward too but for the stream's chunks): B = 1 to 10 and a
# stream's 5-frame chunk (Bb = 257)
K2_SWEEP = tuple(
    [(f"{name} B={B}", 163, 257 * B, In, 384, True) for B in range(1, 11)
     for name, In in (("sb l0", 32), ("sb l1", 384))]
    + [("stream sb l0", 5, 257, 32, 384, False), ("stream sb l1", 5, 257, 384, 384, False)])


def _k2_sweep(rng, cots, dev, out):
    """K2f and K2b (f32) at every shape of ``K2_SWEEP`` in each design the
    checkout has forced (``[cluster]``, ``[wave]``; their order turned round
    between two passes, ``[.. 2]`` keys), and the design its planner takes
    there (``K2 design ...`` keys, the design's name in the ms field; a
    checkout with one design: its plan alone, ``cluster``)."""
    designs = _k2_designs()
    own = designs.pop("")
    designs = designs or {"": own}
    try:
        for label, T, Bb, In, H, backward in K2_SWEEP:
            for kind in (False, True) if backward else (False,):
                p = own(Bb, In, H, kind)
                out[f"K2 design {label}{' bwd' if kind else ''}"] = (
                    getattr(p, "design", "cluster"), None)
            args = cs._inproj_inputs(rng, dev, T, 1, Bb, In, H)
            c = cots((T, 1, Bb, H), (1, Bb, H), (1, Bb, H))
            for rep, order in (("", list(designs)), (" 2", list(designs)[::-1])):
                for suffix in order:
                    k2.plan = designs[suffix]
                    with torch.no_grad():
                        ys, cs_, _, _ = k2._forward(*args, need_cs=True)
                        out[f"K2f {label}{suffix}{rep}"] = (
                            cuda_ms(lambda: k2.fused_lstm_scan_inproj(*args), 5, 1), None)
                        if backward:
                            out[f"K2b {label}{suffix}{rep}"] = (cuda_ms(
                                lambda: k2.fused_lstm_scan_inproj_backward(*args, ys, cs_, *c),
                                2, 1), None)
                        del ys, cs_
    finally:
        k2.plan = own


def _k2_bf16(rng, cots, dev, out):
    """The bf16-stream forms of K2f and K2b at FullSubNet's four layers,
    then their yardsticks (:func:`_k2_bf16_yardsticks`)."""
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
    _k2_bf16_yardsticks(rng, cots, dev, out)


def _k2_cs16(rng, cots, dev, out):
    """K2f and K2b with the bf16 cell-state stash (``cs_dtype=bfloat16``) at
    FullSubNet's four layers, each beside the same call with the f32 stash
    (``... cs32`` keys).  A checkout whose K2 has no stash dtype has no such
    family."""
    bf16, f32 = torch.bfloat16, torch.float32
    for label, T, Bb, In, H in FULLSUBNET_LSTM:
        args = cs._inproj_inputs(rng, dev, T, 1, Bb, In, H)
        c = cots((T, 1, Bb, H), (1, Bb, H), (1, Bb, H))
        with torch.no_grad():
            for tag, dt in (("", bf16), (" cs32", f32)):
                ys, cs_, hT, cT = k2._forward(*args, need_cs=True, cs_dtype=dt)
                ms = cuda_ms(lambda: k2._forward(*args, need_cs=True, cs_dtype=dt), 5, 2)
                out[f"K2f-cs16 {label}{tag}"] = (ms, _hash(ys, cs_, hT, cT))
                g = k2.fused_lstm_scan_inproj_backward(*args, ys, cs_, *c, cs_dtype=dt)
                ms = cuda_ms(lambda: k2.fused_lstm_scan_inproj_backward(
                    *args, ys, cs_, *c, cs_dtype=dt), 3, 1)
                out[f"K2b-cs16 {label}{tag}"] = (ms, _hash(*g))
                del ys, cs_, g


def _k1(rng, cots, dev, out):
    """K1f at DCCRN's enhance shape (Bb=16) and K1b at its train shape
    (Bb=20), f32 then bf16, each beside cuDNN's ``nn.LSTM`` in its dtype
    (one per stack: forward, and forward + backward minus forward), and in
    each tiling where the checkout's K1 has a plan."""
    planner = getattr(k1, "plan", None)
    designs = {"": None}
    if planner is not None:
        from se_tpu_torch.ops import cluster_plan

        def tiles(N, R):
            return lambda L, Bb, H, backward=False: cluster_plan.plan(Bb, 0, H, backward,
                                                                      max_rows=R, N=N)

        designs.update({f" [N={N} R={R}]": tiles(N, R) for N, R in K1_TILES})
    T, L, H = 483, 2, 128
    for dtype, form in ((torch.float32, ""), (torch.bfloat16, "-bf16")):
        for Bb, kind in ((16, "K1f"), (20, "K1b")):
            xp, w, h0, c0 = cs._scan_inputs(rng, dev, T, L, Bb, H)
            xp = xp.to(dtype)
            dys, dhT, dcT = cots((T, L, Bb, H), (L, Bb, H), (L, Bb, H))
            dys = dys.to(dtype)
            try:
                for suffix, design in designs.items():
                    if design is not None:
                        k1.plan = design
                    with torch.no_grad():
                        ys, cs_, hT, cT = k1._forward(xp, w, h0, c0, need_cs=True)
                        if kind == "K1f":
                            ms = cuda_ms(lambda: k1.fused_lstm_scan(xp, w, h0, c0), 50, 3)
                            out[f"K1f{form}{suffix}"] = (ms, _hash(ys, hT, cT))
                        else:
                            c = (dys, dhT, dcT)
                            g = k1.fused_lstm_scan_backward(xp, w, h0, c0, ys, cs_, *c)
                            ms = cuda_ms(lambda: k1.fused_lstm_scan_backward(
                                xp, w, h0, c0, ys, cs_, *c), 20, 2)
                            out[f"K1b{form}{suffix}"] = (ms, _hash(*g))
            finally:
                if planner is not None:
                    k1.plan = planner
            f_ms, b_ms, lib_dtype = cs._cudnn_yardstick(
                cs._cuda_lstms(w, dev), [(xp[:, l], h0[l:l + 1], c0[l:l + 1]) for l in range(L)],
                [(dys[:, l], dhT[l:l + 1], dcT[l:l + 1]) for l in range(L)],
                dtypes=(dtype, torch.float32))
            out[f"cuDNN LSTM{form} {'fwd' if kind == 'K1f' else 'bwd'} Bb={Bb} ({lib_dtype})"] = (
                f_ms if kind == "K1f" else b_ms, None)


def _k4(rng, cots, dev, out):
    """K4 at the default DCCRN's six encoder stages at B=8, f32 then bf16,
    each beside one cuDNN conv of the same function in the same dtype (the
    time padding on both sides, the extra last frame unread)."""
    import torch.nn.functional as F

    for dtype, form in ((torch.float32, ""), (torch.bfloat16, "-bf16")):
        for i, (C, Co, Fq) in enumerate(cs._CONV_STAGES):
            x, w, b = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
                rng.standard_normal((16, C, Fq, 483)), rng.standard_normal((Co, C, 5, 2)) * 0.05,
                rng.standard_normal(Co))]
            x = x.to(dtype)
            wd, bd = w.to(dtype), b.to(dtype)
            with torch.no_grad():
                y = fused_conv.fused_complex_conv2d(x, w, b)
                ms = cuda_ms(lambda: fused_conv.fused_complex_conv2d(x, w, b), 20, 3)
                out[f"K4{form} stage {i + 1}"] = (ms, _hash(y))
                lib_ms = cuda_ms(lambda: F.conv2d(x, wd, bd, stride=(2, 1), padding=(2, 1)), 20, 3)
                out[f"cuDNN conv{form} stage {i + 1}"] = (lib_ms, None)


def _p1(rng, cots, dev, out):
    """The bound probe's four gate modes (K2f's forward kernel) at T=163
    and 1028 rows (B=4) of the sub band's first layer."""
    from se_tpu_torch.probes import bound_probe

    args = bound_probe.inputs(163, 4 * 257, 32, 384, dev)
    with torch.no_grad():
        for mode in bound_probe.MODES:
            ys, hT, cT = bound_probe.run(mode, *args)
            ms = cuda_ms(lambda: bound_probe.run(mode, *args), 3, 1)
            out[f"P1 {mode}"] = (ms, _hash(ys, hT, cT))


def _k2_bf16_yardsticks(rng, cots, dev, out):
    """cuDNN's bf16 ``nn.LSTM`` and K2's plain versions in bf16 at
    FullSubNet's two l1 layers: forward, and backward (cuDNN: forward +
    backward minus forward)."""
    bf16 = torch.bfloat16
    for label, T, Bb, In, H in FULLSUBNET_LSTM[1::2]:
        x, *rest = cs._inproj_inputs(rng, dev, T, 1, Bb, In, H)
        x = x.to(bf16)
        dys, dhT, dcT = cots((T, 1, Bb, H), (1, Bb, H), (1, Bb, H))
        dys = dys.to(bf16)
        with torch.no_grad():
            ys, cs_, _, _ = k2._reference_forward(x, *rest, need_cs=True)
            out[f"plain K2f-bf16 {label}"] = (
                cuda_ms(lambda: k2.fused_lstm_scan_inproj_reference(x, *rest), 1, 1), None)
            out[f"plain K2b-bf16 {label}"] = (cuda_ms(
                lambda: k2.fused_lstm_scan_inproj_backward_reference(
                    x, *rest, ys, cs_, dys, dhT, dcT), 1, 1), None)
        lib = cs._cudnn_lstm(rest[0], rest[1], rest[2], dev)
        f_ms, b_ms, _ = cs._cudnn_yardstick([lib], [(x[:, 0], rest[3], rest[4])],
                                            [(dys[:, 0], dhT, dcT)], dtypes=(bf16,))
        out[f"cuDNN LSTM-bf16 fwd {label}"] = (f_ms, None)
        out[f"cuDNN LSTM-bf16 bwd {label}"] = (b_ms, None)


def _kernel_launches(fn, reps: int = 3) -> list:
    """``[[kernel, us], ...]``: each device launch of one call of ``fn`` in
    order, the least time of ``reps`` calls (torch.profiler, after a call it
    traces and drops, as the tracer starts up).  Where the calls' launches
    do not line up, each kernel's time summed over a call, its name marked
    with its count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    got = []
    keep = lambda p: got.extend(e for e in p.events() if e.device_type == DeviceType.CUDA)
    with profile(activities=[ProfilerActivity.CUDA], on_trace_ready=keep,
                 schedule=schedule(wait=0, warmup=1, active=reps)) as prof:
        for _ in range(reps + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    events = sorted(got, key=lambda e: e.time_range.start)
    name = lambda e: e.name.replace("(anonymous namespace)::", "").replace(
        "void ", "").split("(")[0]
    per_call = len(events) // reps
    calls = [[(name(e), e.time_range.elapsed_us()) for e in events[c * per_call:(c + 1) * per_call]]
             for c in range(reps)]
    if events and len(events) % reps == 0 and all(
            [n for n, _ in c] == [n for n, _ in calls[0]] for c in calls):
        return [[n, min(c[i][1] for c in calls)] for i, (n, _) in enumerate(calls[0])]
    total = {}
    for e in events:
        count, us = total.get(name(e), (0, 0.0))
        total[name(e)] = (count + 1, us + e.time_range.elapsed_us())
    return [[f"{n} x{count / reps:g}", us / reps] for n, (count, us) in total.items()]


# FullSubNet-GRU's sub band at the 10 train steps' batch, B=10 (T=163)
SUB_BAND_B10 = (("sb l0 B=10", 163, 2570, 32, 384), ("sb l1 B=10", 163, 2570, 384, 384))


def _k3_designs() -> dict:
    """``{key suffix: planner}``: the checkout's own plan (``""``) and each
    design it has forced at every shape: ``[cluster]`` and ``[block]`` on
    the cluster tiling, and ``[wave]`` where the checkout has that design
    (``fused_gru_inproj.wave_plan``; H at most 384).  A checkout whose plan
    has a ``cluster`` bool instead of ``design`` forces that bool."""
    import dataclasses

    planner = k3.plan
    designs = {"": planner}
    if not hasattr(k3, "wave_plan"):  # the per-block and cluster designs only
        for d in ("cluster", "block"):
            designs[f" [{d}]"] = (lambda d: lambda *a, **kw: dataclasses.replace(
                planner(*a, **kw), cluster=d == "cluster"))(d)
        return designs
    for d in ("cluster", "block"):
        designs[f" [{d}]"] = (lambda d: lambda Bb, In, H, backward=False, L=1: dataclasses.replace(
            k3.cluster_tiling(Bb, In, H, backward), design=d))(d)
    designs[" [wave]"] = lambda Bb, In, H, backward=False, L=1: k3.wave_plan(Bb, In, H, backward, L)
    return designs


def _k3(rng, cots, dev, out) -> dict:
    """K3f and K3b at FullSubNet-GRU's four layers at B=8 and its sub band
    at B=10, f32 then bf16, each beside cuDNN's ``nn.GRU`` in its dtype, in
    the checkout's design and in each design forced (``_k3_designs``; the
    wave design only at H <= 384); returns each f32 K3b call's launches by
    layer at B=8."""
    designs = _k3_designs()
    launches = {}
    try:
        for dtype, form in ((torch.float32, ""), (torch.bfloat16, "-bf16")):
            for label, T, Bb, In, H in (*FULLSUBNET_LSTM, *SUB_BAND_B10):
                x, *rest = cs._gru_inputs(rng, dev, T, 1, Bb, In, H)
                args = (x.to(dtype), *rest)
                dys, dhT = cots((T, 1, Bb, H), (1, Bb, H))
                c = (dys.to(dtype), dhT)
                for suffix, design in designs.items():
                    if suffix == " [wave]" and H > 384:
                        continue
                    k3.plan = design
                    with torch.no_grad():
                        ys, hT = k3.fused_gru_scan_inproj(*args)
                        ms = cuda_ms(lambda: k3.fused_gru_scan_inproj(*args), 5, 2)
                        out[f"K3f{form} {label}{suffix}"] = (ms, _hash(ys, hT))
                        g = k3.fused_gru_scan_inproj_backward(*args, ys, *c)
                        ms = cuda_ms(lambda: k3.fused_gru_scan_inproj_backward(*args, ys, *c),
                                     3, 1)
                        out[f"K3b{form} {label}{suffix}"] = (ms, _hash(*g))
                        if form == "" and suffix == "" and "B=10" not in label:
                            launches[label] = _kernel_launches(
                                lambda: k3.fused_gru_scan_inproj_backward(*args, ys, *c))
                    del ys, hT, g
                k3.plan = designs[""]
                lib = cs._cudnn_gru(*rest[:4], dev)
                f_ms, b_ms, _ = cs._cudnn_yardstick([lib], [(x[:, 0], rest[4])],
                                                    [(dys[:, 0], dhT)], dtypes=(dtype,))
                out[f"cuDNN GRU{form} fwd {label}"] = (f_ms, None)
                out[f"cuDNN GRU{form} bwd {label}"] = (b_ms, None)
    finally:
        k3.plan = designs[""]
    return launches


# Every K3 shape the paths launch where the sub band's designs compete
# (T, Bb, In, H; backward too but for the stream's chunks): the sub band at
# B = 1 to 10, a stream's 5-frame chunk (Bb = 257) and chip_smoke.py's
# ragged cases outside the cluster design
K3_SWEEP = tuple(
    [(f"{name} B={B}", 163, 257 * B, In, 384, True) for B in range(1, 11)
     for name, In in (("sb l0", 32), ("sb l1", 384))]
    + [("stream sb l0", 5, 257, 32, 384, False), ("stream sb l1", 5, 257, 384, 384, False),
       ("ragged 8-row tiles", 9, 1069, 33, 64, True)])


def _k3_sweep(rng, cots, dev, out):
    """K3f and K3b (f32) at every shape of ``K3_SWEEP`` in each design the
    checkout has but the cluster design (``[block]``, ``[wave]``; their
    order turned round between two passes, ``[.. 2]`` keys), and the
    design its planner takes there (``K3 design ...`` keys, the design's
    name in the ms field)."""
    own = k3.plan
    designs = {k: v for k, v in _k3_designs().items() if k in (" [block]", " [wave]")}
    try:
        for label, T, Bb, In, H, backward in K3_SWEEP:
            p = own(Bb, In, H)
            out[f"K3 design {label}"] = (getattr(p, "design", None)
                                         or ("cluster" if p.cluster else "block"), None)
            x, *rest = cs._gru_inputs(rng, dev, T, 1, Bb, In, H)
            c = cots((T, 1, Bb, H), (1, Bb, H))
            for rep, order in (("", list(designs)), (" 2", list(designs)[::-1])):
                for suffix in order:
                    k3.plan = designs[suffix]
                    with torch.no_grad():
                        ys, _ = k3.fused_gru_scan_inproj(x, *rest)
                        out[f"K3f {label}{suffix}{rep}"] = (
                            cuda_ms(lambda: k3.fused_gru_scan_inproj(x, *rest), 5, 1), None)
                        if backward:
                            out[f"K3b {label}{suffix}{rep}"] = (cuda_ms(
                                lambda: k3.fused_gru_scan_inproj_backward(x, *rest, ys, *c), 2, 1),
                                None)
    finally:
        k3.plan = own


def _p2(rng, cots, dev, out):
    """The wavefront probe at the sub band's two layers at B=8 (T=163,
    Bb=2056, In=32, H=384), and the two K2 calls it is compared with."""
    from se_tpu_torch.probes import wavefront_probe as wp

    args = wp.two_layer_inputs(163, 8 * 257, 32, 384, dev)
    with torch.no_grad():
        for key, fn in (("P2", wp.wavefront_lstm2), ("P2's two K2 calls", wp.sequential_lstm2)):
            got = fn(*args)
            out[key] = (cuda_ms(lambda: fn(*args), 5, 1), _hash(*got))


def _p3(rng, cots, dev, out):
    """P3's dots-only at the sub band's volume at B=8: 1956 steps of the
    176 x 384 tile (groups as the probe's ``main`` passes them)."""
    from se_tpu_torch.probes import vpu_probe

    tile = vpu_probe.tile(dev)
    steps, groups = 163 * 12, 12
    with torch.no_grad():
        got = vpu_probe.run("dots-only", *tile, steps=steps, groups=groups)
        ms = cuda_ms(lambda: vpu_probe.run("dots-only", *tile, steps=steps, groups=groups), 5, 1)
        out["P3 dots-only"] = (ms, _hash(got))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree", sys.argv[2] if len(sys.argv) > 2 else "")
