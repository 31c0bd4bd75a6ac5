#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100.  Phases,
in order; any failure ends the run with a nonzero exit and no result line:

1. environment: card name and power limit, torch, CUDA and nvcc versions;
2. build: every kernel under ``se_tpu_torch/csrc`` into ``build/kernels``,
   one nvcc per source, all started together;
3. each kernel against its plain PyTorch version on the card at its paths'
   shapes (and ragged or wide ones), with CUDA-event times of the kernel,
   the plain version and a library call computing the same function, and
   the kernel's bound: the LSTM scan's forward (K1f, enhance shapes) and
   backward (K1b, train shapes) with the forward's cell-state stash, then
   the in-projection LSTM scan's forward (K2f) and backward (K2b) at CRN's
   enhance and train shapes, DCCRN's real-LSTM shapes, FullSubNet's four
   LSTM layers (at B = 2, 10 and 8), three ragged cases (one where neither
   the rows divide by the cluster's tile nor the units by its CTAs, one of
   two stacks in the wave design) and a wide (4H = 2048, In = 257) case,
   each with the planner's design printed (thread-block clusters, with
   their CTAs, rows, the W_hh slice resident or streamed and shared bytes;
   from B = 3 at the sub band the wave design of 16-row CTAs, with its
   tiles, waves and ring; and the occupancy query's clusters), then the
   in-projection GRU scan's forward (K3f) and
   backward (K3b) at FullSubNet's four GRU layers (B = 2, 10 and 8) and four
   ragged cases, each with the planner's design printed (thread-block
   clusters, with their tiling; the wave design of 16-row CTAs, with its
   tiles, waves, ring and the occupancy query's clusters; or the per-block
   kernel), then the DCCRN
   encoder's fused complex conv (K4) at its six
   stages (B = 10 and 8) and a ragged case, with one cuDNN conv beside it;
   the bf16-stream forms of K1 (DCCRN's enhance and train shapes) and K2
   (CRN's, FullSubNet's sub band and full band, layer 0, and the three
   ragged cases), each backward held on the
   kernel's own saved ys and cs, with the f32 form's time at the same shape
   and cuDNN's LSTM in bf16 beside them; the bf16 forms of K3 (FullSubNet-
   GRU's four layers at B = 2, 10 and 8, four ragged cases, each backward
   held on the kernel's own saved ys) and K4 (the six stages at B = 10 and
   8, a ragged case), by the same phases as their f32 forms, with the f32
   form's time and cuDNN's GRU or conv in bf16 beside them (K4's bound at
   the tensor cores' bf16 rate, its products being bf16); K2f and K2b with
   the bf16 cell-state stash (``cs_dtype=bfloat16``) in both stream forms at
   CRN's train shape, the sub band's layer 0 at B = 2 and the ragged case
   in the wave design, the forward bit
   for bit the f32 stash's but its stash rounded, each against its plain
   version, the gradients also against the f32 stash's within the
   reference's 5e-3 of each leaf's max, with both stashes' times;
   then the f32 forms of K1, K2, K3 and K4 at the streaming path's shapes
   (B = 1, 100-ms chunks: T = 16, 3 and 1 frames at hop 100, 5, 3 and 1 at
   hop 300, from a nonzero state; K4 on the chunk and its cached frame),
   each chunk also as two calls with the state carried, with times;
   then the probes (P1 bound_probe, P2 wavefront_probe, P3 vpu_probe), each
   against its plain version (P1's real mode also bit for bit against K2
   on its cluster design; P2 also against two K2 calls, at a ragged
   tile, in two waves of clusters and twice for the same bits; P3's
   dots-only also at a step count its groups do not divide), then each
   probe's own entry point at the sub band's shape (B = 8, T = 163) with
   every launch count set to 0 just before and read just after;
4. the enhance paths at full width, each with seeded random weights carried
   over from the JAX tree layout: ``enhance_batch`` on 8 three-second
   utterances (every kernel's launch count set to 0 just before and read
   just after), the validation forward and the same weights on the CPU;
   for the default DCCRN, then for CRN
   (the tutorial configuration), DCCRN with ``lstm="real"``, FullSubNet
   (its default LSTM), FullSubNet with ``sequence_model="GRU"`` and the
   default DCCRN's weights with ``use_pallas_conv=True`` (its encoder convs
   through K4; its waveform also held to the default DCCRN's), then DCCRN,
   CRN, DCCRN with ``lstm="real"``, both FullSubNets and DCCRN with
   ``use_pallas_conv`` under ``compute_dtype="bfloat16"`` on the same
   weights (each waveform also held to its f32 path's, the fused conv's to
   DCCRN-bf16's), and DCCRN with ``use_cbn=True`` (the complex BatchNorm)
   and ``skip_type=False``;
   then streaming (``stream_chunks``, B = 1, 100-ms chunks) of one 3-s
   utterance through the default DCCRN, DCCRN with ``lstm="real"`` and
   with ``use_pallas_conv``, CRN, and both FullSubNets with a cumulative
   norm, each held to ``enhance_batch`` over the whole utterance, the
   launches of every chunk and of the end of the stream exact, with each
   chunk's latency, the real-time factor and the peak device memory;
5. the train paths at full width: one ``train_step`` on the card and one on
   the CPU from the same weights (loss, every gradient, the BatchNorm
   running statistics; FullSubNet's dropout set to 0 for this, since two
   devices draw different masks), the kernels' launch counts read around a
   step with and without gradient accumulation, then 5 steps (both
   FullSubNets and their bf16 twins: 10; DCCRN with ``use_pallas_conv``
   and the bf16 DCCRNs and CRN: 3) at the
   default batch of 10 on one fixed batch (the loss must fall; FullSubNet
   with its dropout of 0.8 drawn from a generator on the card), with step
   time, throughput, peak memory and a profile of one step; for the
   default DCCRN, CRN, both FullSubNets, DCCRN with ``use_pallas_conv`` and
   the six bf16 paths (each bf16 gradient against the CPU's at a tolerance
   set by bf16's noise), DCCRN-bf16's 3 steps once more with Adam's first
   moment in bf16, plus one CRN direct-mapping step and one DCCRN real-LSTM
   step against the CPU; then the trainer variants: DCCRN with
   ``perceptual="PMSQE"`` (the card-vs-CPU step, a step with gradient
   accumulation and 5 steps at B=10), and one card-vs-CPU step each of
   DCCRN with LMS in bf16, DCCRN's direct mapping, DCCRN with the complex
   BatchNorm, no skips and LMS, and CRN without skips with LMS (where the
   CPU cannot reproduce its own gradients to TRAIN_GRAD_TOL under a
   one-rounding change of its input: for an ill-conditioned loss, the
   model's gradients for the CPU loss's cotangents at TRAIN_GRAD_TOL; for
   an ill-conditioned model, a multiple of that spread, measured in the
   run); then one CRN step at B=2 with the bf16 stash on, card against CPU
   (K2f-cs16 and K2b-cs16 once each); one step at B=10 of the default DCCRN
   and of DCCRN with ``use_pallas_conv`` with ``remat_convs=True`` against
   the same step without it (loss, gradients, running statistics, the
   recompute's K4 launches, peak device memory); one FullSubNet forward at
   B=2 with ``weight_init=True`` and the three EMA norms, card against CPU;
6. the enhance CLI as a subprocess for every path but the two fused-conv
   ones (no CLI takes that switch) and the four that only train (bf16
   paths with ``--compute-dtype bfloat16``; DCCRN with ``--use-cbn
   --no-skip``, its 3-s file also held to phase 4's waveform), all started
   at once after the timed phases, each output held to the same weights in
   process; meanwhile the CLI's ``main`` in this process with
   ``--streaming`` for DCCRN, CRN and FullSubNet, each held to the stream
   in process;
6b. data-parallel training: two ranks spawned on the one card (gloo; they
   start before phase 6 and train while it runs), each taking 5 rows of the
   default DCCRN's global batch of 10 for 3 ``parallel_train_step``s, held to
   the one-process step on all 10 (losses, the first step's gradients and
   running statistics, every leaf after the last step), each rank's K1f and
   K1b launches exact;
7. the train CLI, ``python -m se_tpu_torch.train_interface``, for the
   default DCCRN at full width: 2 epochs at ``--batch 4`` on 8 training and
   4 validation utterances of 3 s, a corpus that the port's builder
   (``python -m se_tpu_torch.data.make_synth_corpus``, a subprocess) writes
   through its synthesis and packing, with the native PESQ and STOI, in process
   (K1f and K1b launch counts, the run directory, the scores), a resume of
   its epoch 1 in a subprocess held to its epoch 2, ``Epoch_1_SCORES``
   held to a recomputation from ``chkpt_1.pt``, and meanwhile the CLI with
   ``--mesh`` for 1 epoch under ``torch.distributed.run --nproc_per_node=1``
   (NCCL), its run directory and ``chkpt_1.pt`` held to the in-process
   run's;
8. report: one JSON line of kernel numbers, then the result line.

TF32 is off throughout (``resolve_device`` sets it, and keeps cuBLAS's bf16
products reducing in f32): the reference is f32, or bf16 where it says so.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): f32 outside the tensor
# cores, bf16 on the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

KERNEL_TOL = 1e-4  # kernel vs plain on the card, f32 over 483 steps
# backward kernel vs plain, relative to each output's max |value|: dgates
# carry 483 steps of f32 rounding back, and dW_hh sums 9,660 rows in
# another order than the plain version's per-step products
BWD_REL_TOL = 1e-4
SLICE_TOL = 1e-3  # enhanced waveform, card vs CPU plain path
CLI_TOL = 2 / 32768  # CLI output vs in-process, int16 LSBs
# train step, card vs CPU plain path, same weights and batch: the loss
# relative to max(1, |loss|); running statistics absolute; each gradient
# leaf's max |card - CPU| relative to max(its max |CPU value|, GRAD_FLOOR x
# the largest gradient of the model).  cuDNN's convolution backward and the
# BatchNorm backward's sums over B x F x T run in another order than on the
# CPU; a leaf that is itself such a sum with heavy cancellation (a PReLU
# slope sums ~2 M products of both signs) carries an error set by the size
# of its terms, which the floor measures against the gradients flowing in.
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-2
TRAIN_STATS_TOL = 1e-5
# Three f32 paths whose gradients at their seeded weights the CPU cannot
# reproduce to TRAIN_GRAD_TOL itself: one CPU step from an input changed by
# one f32 rounding (a relative 2^-23 x N(0, 1) on each sample) moves a leaf
# by ~1e-3 (DCCRN-PMSQE; DCCRN-cbn-noskip, whose random decoder without
# skips leaves its masks near 0, where the E mask's phase is ill-conditioned,
# and whose complex BatchNorm whitens) to 8 (CRN-noskip-LMS: its random tanh
# masks leave ~90% of the mel values below 0, and LMS's clamp, whose log has
# slope 1 / (x + 1e-7) just above 0, switches on and off).  These paths hold
# card vs CPU on the model's gradients for one set of cotangents of its
# outputs, the CPU step's loss's, which takes the loss's own switching out
# (``_cotangent_grads``), to max(TRAIN_GRAD_TOL, CONDITION_FACTOR x the
# spread of those gradients on the CPU under the nudge above), measured in
# the run; their full steps' gradients are printed and must be finite.
# Two summation orders in every layer read about one nudge's spread
# (PERF.md, section 6).
ILL_CONDITIONED = ("DCCRN-PMSQE", "DCCRN-cbn-noskip", "CRN-noskip-LMS")
CONDITION_FACTOR = 10
# calls of a path's forward or train step that torch.profiler traces; one,
# to keep the script within its time (each traced call costs ~1 s of host
# time for the trace)
PROFILE_CALLS = 1
# The bf16 paths, card vs CPU (both bf16, the same weights and batch).
# cuDNN's convolutions and the CPU's sum in other orders; where two f32 sums
# differ in their last bit a bf16 rounding tips, and the tip travels down the
# network, so the waveform and the loss agree to bf16's precision, not f32's.
# The same holds for one row run in batches of two sizes (cuDNN picks its
# algorithms by shape), so the CLI is held to in-process runs of its own
# batches at CLI_TOL and to one row at a time at BF16_SLICE_TOL.  The
# gradients: every cotangent is rounded to bf16, so a leaf that sums
# millions of products of both signs (a PReLU slope, a bias) carries bf16
# noise of the order of its own size (on the CPU the JAX package's bf16
# gradients differ from its f32 ones by up to 5x a PReLU slope's max,
# tests/test_torch_bf16.py).  Each leaf's max |card - cpu| is held against
# max(its max, GRAD_FLOOR x the model's largest gradient): all leaves at
# BF16_GRAD_TOL, the recurrent bottleneck's (the hand kernels' weights and
# the linear maps around them, ``_BOTTLENECK``) at BF16_LSTM_GRAD_TOL.  Each
# limit is 2.3-4x the largest value measured over DCCRN-bf16, CRN-bf16 and
# DCCRN-real-bf16 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 2);
# DCCRN-fused-conv-bf16, the same network, reads within them, and so do the
# FullSubNet bf16 paths but for their gradients, which have limits of their
# own (FSN_BF16_*).
BF16_SLICE_TOL = 5e-3  # waveform max |card - cpu|; measured 2.15e-3
BF16_SLICE_MEAN_TOL = 5e-4  # waveform mean |card - cpu|; measured 1.81e-4
BF16_LOSS_TOL = 1e-3  # loss, relative to max(1, |loss|); measured 4.0e-4
BF16_GRAD_TOL = 0.5  # measured 0.173 (a conv bias that a BatchNorm cancels)
BF16_LSTM_GRAD_TOL = 1e-2  # measured 2.39e-3
# FullSubNet's bf16 gradients (LSTM and GRU): no convolution or BatchNorm
# sums in cuDNN's order, so its leaves agree far more closely; each limit
# about 4x the larger of its two paths' readings (same card)
FSN_BF16_GRAD_TOL = 4e-3  # measured 1.04e-3 (the GRU's sb_model.fc_output_layer.weight)
FSN_BF16_LSTM_GRAD_TOL = 7e-5  # measured 1.81e-5
# the recurrent bottleneck's leaves: DCCRN's and CRN's ``enhance.*``,
# FullSubNet's two sequence models' RNN weights
_BOTTLENECK = ("enhance.", "fb_model.sequence_model.", "sb_model.sequence_model.")
BF16_STATS_TOL = 2e-3  # running statistics, absolute; measured 6.7e-4
# bf16 against the f32 path on the same weights and input, mean |difference|
# of the waveform: the JAX package's own gate
# (tests/test_model_variants.py::test_dccrn_bf16_compute_close_to_f32)
BF16_VS_F32_MEAN = 5e-3
# The train CLI (phase 7): a resumed run's epoch 2 against the uninterrupted
# run's.  Both start epoch 2 from the same chkpt_1.pt, so they differ only by
# cuDNN's nondeterministic convolution weight gradients over two steps; the
# conv biases that feed a BatchNorm have roundoff gradients, whose sign Adam
# turns into a step of about lr, so they (and those BatchNorms' running
# means, which take them in) are held to Adam's bound for the two steps,
# 2 lr (sqrt(3) + sqrt(4)); every other leaf of chkpt_2.pt (parameters,
# buffers, Adam's moments) to RESUME_LEAF_TOL of its max, and the epoch-2
# validation loss, which sees the biases in eval mode, to RESUME_LOSS_TOL
# relative.  Each limit lies between the sound resumes' largest reading and
# the smallest of two planted faults (resume_faults.py): Adam's state
# dropped on restore, and epoch 1's batches replayed.  Each PESQ and STOI of
# Epoch_1_SCORES is held to a recomputation from chkpt_1.pt at the file's 6
# decimals.
TRAIN_CLI_BATCH = 4
# sound: 1.59e-4 to 3.64e-3 in 7 resumes (Adam moments of conv weights);
# faults: 2.32 (Adam's state dropped), 2.70 (batches replayed)
RESUME_LEAF_TOL = 2e-2
# sound: 2.15e-5 to 4.78e-4 in 7 resumes; faults: 3.58e-2, 4.04e-2
RESUME_LOSS_TOL = 2e-3
SCORES_TOL = 1e-6
# The data-parallel step (phase 6b): DP_WORLD ranks on the one card, each a
# process of its own over gloo (NCCL takes one rank a card), each on its
# rows of the default DCCRN's global batch of 10, against the one-process
# step on all 10, DP_STEPS steps from the same weights.  The ranks' BatchNorm
# sums and gradients are reduced in another order than one process's, so
# the yardstick is the one-process step with its batch's halves swapped:
# each step's loss at TRAIN_LOSS_TOL and the running statistics at
# TRAIN_STATS_TOL, the card-vs-CPU step's limits; the first step's
# gradients (over max(the leaf's max, GRAD_FLOOR x the largest)) at
# max(TRAIN_GRAD_TOL, CONDITION_FACTOR x the swapped run's worst reading:
# at B=10 a PReLU slope's gradient, a sum of ~20 M terms of both signs,
# reads 1.6e-3 on an NVIDIA H100 80GB HBM3, PERF.md section 2); after the
# last step every leaf (parameters, buffers, Adam's moments) at
# max(RESUME_LEAF_TOL, CONDITION_FACTOR x the swapped run's reading of that
# leaf) of its max, and the BatchNorm-cancelled conv biases, their moments
# and their BatchNorms' running means at Adam's bound over the steps run
# (``_adam_bound``), the resume check's rules.
DP_WORLD = 2
DP_STEPS = 3


def _adam_bound(lr: float, steps: int) -> float:
    """The most two Adam runs can part on a leaf in ``steps`` steps from the
    same value: Adam moves a parameter by at most lr sqrt(t) at step t."""
    return 2 * lr * sum(t**0.5 for t in range(1, steps + 1))


def _max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _bound(n_bytes, flops, peak_flops=PEAK_F32_FLOPS) -> tuple:
    """The least time for moving ``n_bytes`` and doing ``flops`` at
    ``peak_flops`` (f32 products by default; bf16 products at the tensor
    cores' bf16 rate) on the card, in ms, and which of the two bounds it."""
    bytes_ms, flops_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S, 1e3 * flops / peak_flops
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def _profile(fn, steps: int, top: int = 12):
    """Device time per call of ``fn`` by kernel, from torch.profiler, and
    the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    # kernel rows only: the aten rows repeat the time of the kernels they launch
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    print(f"[profile] per call: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[profile] {e.self_device_time_total / 1e3 / steps:9.3f} ms "
              f"x{e.count // steps:<4d} {e.key[:90]}")


def phase_environment() -> str:
    if not (REPO / "se_tpu_torch").is_dir():
        sys.exit("chip_smoke.py must run from a checkout holding se_tpu_torch/")
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[env] nvidia-smi: {smi}")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    from se_tpu_torch.ops import build

    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()
    print(f"[env] nvcc: {nvcc[-1]}")
    return smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from se_tpu_torch.eval import pesq_native
    from se_tpu_torch.ops import build

    t0 = time.perf_counter()
    # the host library of the native PESQ and composite measures (phase 7's
    # scoring) builds beside the kernels
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(pesq_native.load)
        logs = build.build()
        host.result()
    print(f"[build] {build.kernel_names()} and the native metrics library in "
          f"{time.perf_counter() - t0:.2f} s")
    # ptxas names each kernel mangled; cu++filt, beside nvcc, demangles it
    # (-p: without the parameter types)
    cu_filt = str(Path(build._nvcc()).with_name("cu++filt"))
    for name, log in logs.items():
        kernel = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = subprocess.run([cu_filt, "-p", line.split("'")[1]], capture_output=True,
                                        text=True, check=True, timeout=60).stdout.strip()
            elif "registers" in line or "spill" in line:
                print(f"[build] {name} {kernel}: {line.strip().removeprefix('ptxas info    : ')}")


def _scan_inputs(rng, dev, T, L, Bb, H):
    """x_proj, w_hh_t (torch's init range), nonzero h0 and c0."""
    host = [
        rng.standard_normal((T, L, Bb, 4 * H)),
        rng.uniform(-1 / np.sqrt(H), 1 / np.sqrt(H), (L, H, 4 * H)),
        rng.standard_normal((L, Bb, H)) * 0.5,
        rng.standard_normal((L, Bb, H)) * 0.5,
    ]
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in host]


def _cuda_lstms(w, dev):
    """Yardstick only, never called by the port: one cuDNN ``nn.LSTM`` per
    stack with an identity input projection and zero biases, which computes
    the same function as the fused scan of ``x_proj``."""
    L, H = w.shape[0], w.shape[1]
    lstms = []
    for l in range(L):
        m = torch.nn.LSTM(4 * H, H).to(dev)
        with torch.no_grad():
            m.weight_ih_l0.copy_(torch.eye(4 * H, device=dev))
            m.weight_hh_l0.copy_(w[l].T)
            m.bias_ih_l0.zero_()
            m.bias_hh_l0.zero_()
        lstms.append(m)
    return lstms


def _k1_tiling(L, Bb, H) -> str:
    """K1's tiling for its forward and backward scans at a shape, from
    ``fused_lstm.plan``: clusters a stack x CTAs, rows a cluster, units a
    CTA, the W_hh slice resident or streamed, chunk steps, shared bytes a
    CTA, and how many such clusters the card runs at once."""
    from se_tpu_torch.ops.fused_lstm import active_clusters, plan

    def one(backward):
        p = plan(L, Bb, H, backward)
        return (f"{p.tiles} x {p.N} CTAs, R={p.R}, U={p.U}, "
                f"{'resident' if p.resident else 'streamed'}, C={p.C}, {p.smem} B, "
                f"{active_clusters(L, Bb, H, backward)} clusters at once")

    return f"forward {one(False)}; backward {one(True)}"


def phase_lstm_kernel() -> dict:
    """fused_lstm_scan at the main path's shapes: T=483 frames (3 s at hop
    100 with the conv-STFT's 300-sample pads), L=2 stacks, Bb=16 rows
    (B=8 doubled), H=128 (rnn_units=256 halved), and at the train batch's
    Bb=20, each with the plan's tiling printed; a ragged case."""
    from se_tpu_torch.device import resolve_device
    from se_tpu_torch.probes import cuda_ms
    from se_tpu_torch.ops.fused_lstm import fused_lstm_scan, fused_lstm_scan_reference

    dev = resolve_device("cuda")
    rng = np.random.default_rng(SEED)
    T, L, Bb, H = 483, 2, 16, 128
    xp, w, h0, c0 = _scan_inputs(rng, dev, T, L, Bb, H)
    with torch.inference_mode():
        ys, (hT, cT) = fused_lstm_scan(xp, w, h0, c0)
        ys_p, (hT_p, cT_p) = fused_lstm_scan_reference(xp, w, h0, c0)
        torch.cuda.synchronize()
        errs = {"ys": _max_err(ys, ys_p), "hT": _max_err(hT, hT_p), "cT": _max_err(cT, cT_p)}
        print(f"[lstm] Bb={Bb} ({_k1_tiling(L, Bb, H)}): max |kernel - plain| {errs} "
              f"(tolerance {KERNEL_TOL})")
        assert all(np.isfinite(v) and v <= KERNEL_TOL for v in errs.values()), errs

        # the train batch's rows, and a ragged shape: three stacks, Bb not
        # a multiple of the row tile, H = 32 over 8 CTAs of 4 units
        for label, shape in (("Bb=20", (T, L, 20, H)), ("ragged T=7 L=3 Bb=5 H=32", (7, 3, 5, 32))):
            case = _scan_inputs(rng, dev, *shape)
            got = fused_lstm_scan(*case)
            want = fused_lstm_scan_reference(*case)
            r_err = max(_max_err(got[0], want[0]), _max_err(got[1][0], want[1][0]),
                        _max_err(got[1][1], want[1][1]))
            print(f"[lstm] {label} ({_k1_tiling(*shape[1:])}): max |kernel - plain| "
                  f"{r_err}")
            assert r_err <= KERNEL_TOL, (label, r_err)

        lib = _cuda_lstms(w, dev)

        def library():
            return [lib[l](xp[:, l], (h0[l : l + 1], c0[l : l + 1])) for l in range(L)]

        lib_err = max(_max_err(out[0], ys[:, l]) for l, out in enumerate(library()))
        print(f"[lstm] max |cuDNN LSTM - kernel| {lib_err}")

        kernel_ms = cuda_ms(lambda: fused_lstm_scan(xp, w, h0, c0), iters=50, warmup=3)
        plain_ms = cuda_ms(lambda: fused_lstm_scan_reference(xp, w, h0, c0), iters=5, warmup=1)
        library_ms = cuda_ms(library, iters=50, warmup=3)

    n_bytes = 4 * (xp.numel() + w.numel() + h0.numel() + c0.numel()
                   + ys.numel() + hT.numel() + cT.numel())
    flops = 2 * T * L * Bb * H * 4 * H + T * L * Bb * 4 * H  # h @ W_hh, + x_proj
    bound_ms, bound_by = _bound(n_bytes, flops)
    print(f"[lstm] kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} library_ms "
          f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}: {n_bytes} B, {flops} FLOP)")
    return {
        "name": "fused_lstm_scan_fwd",
        "route": "cuda",
        "source": "se_tpu_torch/csrc/lstm_scan.cu",
        "replaces": "se_tpu/ops/pallas_lstm.py:200::fused_lstm_scan",
        "max_abs_err": max(errs.values()),
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def _rel_errs(got, want) -> dict:
    """Max |got - want| of each output, over that output's max |want|."""
    names = ("dx_proj", "dw_hh_t", "dh0", "dc0")
    return {n: _max_err(g, w) / max(w.abs().max().item(), 1e-30)
            for n, g, w in zip(names, got, want)}


def phase_lstm_backward() -> tuple:
    """fused_lstm_scan_backward at the train path's shapes: T=483, L=2,
    Bb=20 (the default batch of 10 doubled), H=128, each with the plan's
    tiling printed; the forward's stash; the enhance batch's Bb=16 and a
    ragged case.  Returns the K1b entry and the stash forward's times."""
    from se_tpu_torch.device import resolve_device
    from se_tpu_torch.probes import cuda_ms
    from se_tpu_torch.ops import fused_lstm
    from se_tpu_torch.ops.fused_lstm import (
        fused_lstm_scan_backward,
        fused_lstm_scan_backward_reference,
    )

    dev = resolve_device("cuda")
    rng = np.random.default_rng(SEED + 1)

    def case(T, L, Bb, H):
        """Forward inputs, the kernel's (ys, cs) and seeded cotangents."""
        xp, w, h0, c0 = _scan_inputs(rng, dev, T, L, Bb, H)
        ys, cs, _, _ = fused_lstm._forward(xp, w, h0, c0, need_cs=True)
        cots = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
                for s in ((T, L, Bb, H), (L, Bb, H), (L, Bb, H))]
        return (xp, w, h0, c0, ys, cs, *cots)

    T, L, Bb, H = 483, 2, 20, 128
    args = case(T, L, Bb, H)
    xp, w, h0, c0, ys, cs, dys, dhT, dcT = args
    with torch.no_grad():
        # the stash changes nothing of the forward's results
        ys_n, cs_n, hT_n, cT_n = fused_lstm._forward(xp, w, h0, c0, need_cs=False)
        ys_s, cs_s, hT_s, cT_s = fused_lstm._forward(xp, w, h0, c0, need_cs=True)
        assert cs_n is None
        assert torch.equal(ys_n, ys_s) and torch.equal(hT_n, hT_s) and torch.equal(cT_n, cT_s)
        _, cs_p, _, _ = fused_lstm._reference_forward(xp, w, h0, c0, need_cs=True)
        cs_err = _max_err(cs_s, cs_p)
        print(f"[lstm-bwd] stash forward: ys bit-identical to the stash-free one; "
              f"max |cs - plain cs| {cs_err} (tolerance {KERNEL_TOL})")
        assert cs_err <= KERNEL_TOL, cs_err

        got = fused_lstm_scan_backward(*args)
        again = fused_lstm_scan_backward(*args)
        want = fused_lstm_scan_backward_reference(*args)
        torch.cuda.synchronize()
        errs = _rel_errs(got, want)
        abs_err = max(_max_err(g, w_) for g, w_ in zip(got, want))
        print(f"[lstm-bwd] Bb={Bb} ({_k1_tiling(L, Bb, H)}): max |kernel - plain| / max |plain| "
              f"{errs} (tolerance {BWD_REL_TOL}); max abs {abs_err}")
        assert all(np.isfinite(v) and v <= BWD_REL_TOL for v in errs.values()), errs
        assert all(torch.equal(a, b) for a, b in zip(got, again)), "backward not deterministic"
        print("[lstm-bwd] two backward calls: dx_proj, dW_hh, dh0, dc0 bit-identical")

        for label, shape in (("Bb=16", (T, L, 16, H)), ("ragged T=7 L=3 Bb=5 H=32", (7, 3, 5, 32))):
            other = case(*shape)
            r_got = fused_lstm_scan_backward(*other)
            r_errs = _rel_errs(r_got, fused_lstm_scan_backward_reference(*other))
            print(f"[lstm-bwd] {label}: {r_errs}")
            assert all(v <= BWD_REL_TOL for v in r_errs.values()), (label, r_errs)
            assert all(torch.equal(a, b) for a, b in zip(r_got, fused_lstm_scan_backward(*other))), \
                f"{label}: backward not deterministic"

        kernel_ms = cuda_ms(lambda: fused_lstm_scan_backward(*args), iters=20, warmup=2)
        plain_ms = cuda_ms(lambda: fused_lstm_scan_backward_reference(*args), iters=3, warmup=1)
        fwd_ms = cuda_ms(lambda: fused_lstm._forward(xp, w, h0, c0, need_cs=False),
                          iters=20, warmup=2)
        fwd_stash_ms = cuda_ms(lambda: fused_lstm._forward(xp, w, h0, c0, need_cs=True),
                                iters=20, warmup=2)
    print(f"[lstm-bwd] forward at Bb={Bb}: {fwd_ms:.4f} ms without the stash, "
          f"{fwd_stash_ms:.4f} ms with it")

    # yardstick: cuDNN's LSTM backward, timed as (forward + backward) - forward
    lstms = _cuda_lstms(w, dev)
    leaves = [(xp[:, l].clone().requires_grad_(), h0[l : l + 1].clone().requires_grad_(),
               c0[l : l + 1].clone().requires_grad_()) for l in range(L)]

    def lib_forward():
        return [lstms[l](x, (h, c)) for l, (x, h, c) in enumerate(leaves)]

    def lib_forward_backward():
        return [torch.autograd.grad(
            (out, hN, cN), (*leaves[l], lstms[l].weight_hh_l0),
            (dys[:, l], dhT[l : l + 1], dcT[l : l + 1]),
        ) for l, (out, (hN, cN)) in enumerate(lib_forward())]

    lib_dx = lib_forward_backward()[0][0]
    print(f"[lstm-bwd] max |cuDNN dx - kernel dx_proj| (stack 0) {_max_err(lib_dx, got[0][:, 0])}")
    lib_fwd_ms = cuda_ms(lib_forward, iters=20, warmup=2)
    lib_ms = cuda_ms(lib_forward_backward, iters=20, warmup=2) - lib_fwd_ms

    G = 4 * H
    # read x_proj, w, ys, cs, dys, h0, c0, dhT, dcT; write dx_proj, dW, dh0, dc0
    n_bytes = 4 * (2 * xp.numel() + 2 * w.numel() + 3 * ys.numel() + 6 * h0.numel())
    flops = 3 * 2 * T * L * Bb * H * G  # the gate recompute, dh and dW products
    bound_ms, bound_by = _bound(n_bytes, flops)
    print(f"[lstm-bwd] kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} library_ms "
          f"{lib_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}: {n_bytes} B, {flops} FLOP)")
    entry = {
        "name": "fused_lstm_scan_bwd",
        "route": "cuda",
        "source": "se_tpu_torch/csrc/lstm_scan.cu",
        "replaces": "se_tpu/ops/pallas_lstm.py:217::_fused_bwd",
        "max_abs_err": abs_err,
        "max_rel_err": max(errs.values()),
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    }
    return entry, {"fwd_ms_train_shape": fwd_ms, "fwd_stash_ms_train_shape": fwd_stash_ms}


def _inproj_inputs(rng, dev, T, L, Bb, In, H):
    """x, w_ih_t, bias, w_hh_t (torch's init range), nonzero h0 and c0."""
    k = 1 / np.sqrt(H)
    host = [
        rng.standard_normal((T, L, Bb, In)),
        rng.uniform(-k, k, (L, In, 4 * H)),
        rng.uniform(-2 * k, 2 * k, (L, 4 * H)),
        rng.uniform(-k, k, (L, H, 4 * H)),
        rng.standard_normal((L, Bb, H)) * 0.5,
        rng.standard_normal((L, Bb, H)) * 0.5,
    ]
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in host]


def _cudnn_lstm(w_ih_t, bias, w_hh_t, dev):
    """Yardstick only, never called by the port: a cuDNN ``nn.LSTM(In, H)``
    holding stack 0's weights, which computes the in-projection scan's
    function."""
    In, H = w_ih_t.shape[1], w_hh_t.shape[1]
    m = torch.nn.LSTM(In, H).to(dev)
    with torch.no_grad():
        m.weight_ih_l0.copy_(w_ih_t[0].T)
        m.weight_hh_l0.copy_(w_hh_t[0].T)
        m.bias_ih_l0.copy_(bias[0])
        m.bias_hh_l0.zero_()
    return m


_K2B_NAMES = ("dx", "dw_ih_t", "dbias", "dw_hh_t", "dh0", "dc0")
# K2's ragged case in the wave design: (label, T, L, Bb, In, H), two stacks
# of 600 rows (38 tiles of 16, the last of 8), In = 20 padded to 24, H =
# 200 padded to 224 units (seven consumer warps)
_K2_RAGGED_WAVE = ("ragged wave, two stacks", 7, 2, 600, 20, 200)


def _k2_tiling(Bb, In, H, L=1) -> str:
    """The planner's design for K2's forward and backward scans at a shape:
    on clusters (clusters x CTAs, rows a cluster, units a CTA, the W_hh
    slice resident or streamed, chunk steps, shared bytes a CTA, and how
    many such clusters the card runs at once), or in waves of 16-row CTAs
    (tiles, clusters of N, waves, ring slabs, x's padded rows, shared bytes
    a CTA and the occupancy query's clusters at once)."""
    from se_tpu_torch.ops.fused_lstm_inproj import active_clusters, plan

    def one(backward):
        p = plan(Bb, In, H, backward, L)
        fits = active_clusters(Bb, In, H, backward, L=L)
        if p.design == "wave":
            return (f"wave design, {p.tiles} tiles of {p.R} rows a stack in {p.clusters} clusters "
                    f"of {p.N} CTAs, {p.waves} wave(s), ring of {p.stages} slabs, In_p={p.In_p}, "
                    f"Hp={p.Hp}, {p.smem} B, {fits} clusters at once")
        return (f"clusters, {p.tiles} x {p.N} CTAs, R={p.R}, U={p.U}, "
                f"{'resident' if p.resident else 'streamed'}, C={p.C}, {p.smem} B, "
                f"{fits} clusters at once")

    return f"forward {one(False)}; backward {one(True)}"


def _k2_bound(T, L, Bb, In, H, stream_bytes=4, backward=False, stash_bytes=None) -> tuple:
    """K2's bound at a shape -> ``(bound_ms, bound_by, bytes, FLOP)``: the
    forward reads x, the weights, h0 and c0 and writes ys, hT and cT (2 T L
    Bb (In + H) 4H FLOP, + the bias), and the stash cs where ``stash_bytes``
    is given; the backward reads x, the weights, h0, c0, ys, cs, dys, dhT and
    dcT and writes dx, the weight gradients, dh0 and dc0 (three times the
    products).  x, ys, dys and dx at ``stream_bytes`` each (bf16: 2), cs at
    ``stash_bytes`` (default 4), the rest f32."""
    G = 4 * H
    n_w = L * (In * G + G + H * G)
    n_cs = T * L * Bb * H
    if backward:
        n_bytes = (stream_bytes * (2 * T * L * Bb * In + 2 * T * L * Bb * H)
                   + (4 if stash_bytes is None else stash_bytes) * n_cs
                   + 4 * (2 * n_w + 6 * L * Bb * H))
        flops = 3 * 2 * T * L * Bb * (In + H) * G
    else:
        n_bytes = (stream_bytes * T * L * Bb * (In + H) + (stash_bytes or 0) * n_cs
                   + 4 * (n_w + 4 * L * Bb * H))
        flops = 2 * T * L * Bb * (In + H) * G + T * L * Bb * G
    return (*_bound(n_bytes, flops), n_bytes, flops)


def phase_inproj_kernels() -> tuple:
    """fused_lstm_scan_inproj (K2f) and its backward (K2b): CRN's bottleneck
    at the enhance shape (T=483, L=1, Bb=8, In=512, H=128) and the train
    shape (Bb=10); DCCRN's real LSTM layers (In=1024 and 256, H=256) at
    Bb=8 and 2; three ragged cases (T=7, L=3, Bb=5, In=24, H=32; T=7, L=2,
    Bb=37, In=20, H=44: two tiles of 20 rows, 6 CTAs of 8 units but the
    last of 4; ``_K2_RAGGED_WAVE``, two stacks in the wave design); a wide case
    with 4H above the block's threads and an odd In (FullSubNet's full band:
    T=193, Bb=2, In=257, H=512).  Returns the K2f and K2b entries."""
    from se_tpu_torch.device import resolve_device
    from se_tpu_torch.probes import cuda_ms
    from se_tpu_torch.ops import fused_lstm_inproj as k2

    dev = resolve_device("cuda")
    rng = np.random.default_rng(SEED + 2)

    def check(label, T, L, Bb, In, H):
        """The wrapper's forward against the plain version; the stash
        forward's results bit-identical to the wrapper's and its cs against
        the plain cs; the backward against its plain version, two calls
        bit-identical.  Returns the inputs, the kernel's (ys, cs), seeded
        cotangents and the errors."""
        args = _inproj_inputs(rng, dev, T, L, Bb, In, H)
        cots = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
                for s in ((T, L, Bb, H), (L, Bb, H), (L, Bb, H))]
        with torch.no_grad():
            ys_n, (hT_n, cT_n) = k2.fused_lstm_scan_inproj(*args)
            ys, cs, hT, cT = k2._forward(*args, need_cs=True)
            assert torch.equal(ys_n, ys) and torch.equal(hT_n, hT) and torch.equal(cT_n, cT), \
                f"{label}: the stash changed the forward's results"
            ys_p, (hT_p, cT_p) = k2.fused_lstm_scan_inproj_reference(*args)
            _, cs_p, _, _ = k2._reference_forward(*args, need_cs=True)
            got = k2.fused_lstm_scan_inproj_backward(*args, ys, cs, *cots)
            again = k2.fused_lstm_scan_inproj_backward(*args, ys, cs, *cots)
            want_b = k2.fused_lstm_scan_inproj_backward_reference(*args, ys, cs, *cots)
            torch.cuda.synchronize()
        fwd_errs = {n: _max_err(g, w) for n, g, w in zip(
            ("ys", "cs", "hT", "cT"), (ys_n, cs, hT_n, cT_n), (ys_p, cs_p, hT_p, cT_p))}
        rel = {n: _max_err(g, w) / max(w.abs().max().item(), 1e-30)
               for n, g, w in zip(_K2B_NAMES, got, want_b)}
        bwd_abs = max(_max_err(g, w) for g, w in zip(got, want_b))
        print(f"[k2] {label} T={T} L={L} Bb={Bb} In={In} H={H}: {_k2_tiling(Bb, In, H, L)}; "
              f"forward max |kernel - plain| {fwd_errs}; backward max |kernel - plain| / "
              f"max |plain| {rel}, max abs {bwd_abs}")
        assert all(np.isfinite(v) and v <= KERNEL_TOL for v in fwd_errs.values()), (label, fwd_errs)
        assert all(np.isfinite(v) and v <= BWD_REL_TOL for v in rel.values()), (label, rel)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{label}: backward not repeatable"
        return args, ys, cs, cots, max(fwd_errs.values()), max(rel.values()), bwd_abs

    for case in (("ragged", 7, 3, 5, 24, 32), ("ragged tiles and units", 7, 2, 37, 20, 44),
                 _K2_RAGGED_WAVE, ("wide", 193, 1, 2, 257, 512)):
        check(*case)
    print("[k2] every case: ys, hT, cT bit-identical with and without the stash; "
          "two backward calls bit-identical")

    # enhance shape: the forward's numbers
    T, L, Bb, In, H = 483, 1, 8, 512, 128
    G = 4 * H
    args, ys, _, _, fwd_err, _, _ = check("CRN enhance", T, L, Bb, In, H)
    lib = _cudnn_lstm(args[1], args[2], args[3], dev)
    x, h0, c0 = args[0], args[4], args[5]
    with torch.inference_mode():
        lib_err = _max_err(lib(x[:, 0], (h0, c0))[0], ys[:, 0])
        print(f"[k2] max |cuDNN LSTM - kernel| ys {lib_err}")
        kernel_ms = cuda_ms(lambda: k2.fused_lstm_scan_inproj(*args), iters=20, warmup=2)
        plain_ms = cuda_ms(lambda: k2.fused_lstm_scan_inproj_reference(*args), iters=3, warmup=1)
        library_ms = cuda_ms(lambda: lib(x[:, 0], (h0, c0)), iters=20, warmup=2)
        stash_ms = cuda_ms(lambda: k2._forward(*args, need_cs=True), iters=20, warmup=2)
    bound_ms, bound_by, n_bytes, flops = _k2_bound(T, L, Bb, In, H)
    print(f"[k2] forward kernel_ms {kernel_ms:.4f} (with the stash {stash_ms:.4f}) plain_ms "
          f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} "
          f"({bound_by}: {n_bytes} B, {flops} FLOP)")
    fwd = {
        "name": "fused_lstm_scan_inproj_fwd",
        "route": "cuda",
        "source": "se_tpu_torch/csrc/lstm_inproj.cu",
        "replaces": "se_tpu/ops/pallas_lstm.py:432::_inproj_call",
        "max_abs_err": fwd_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "stash_ms": stash_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }

    # train shape: the backward's numbers
    Bb = 10
    args, ys, cs, cots, _, rel_err, abs_err = check("CRN train", T, L, Bb, In, H)
    dys, dhT, dcT = cots
    with torch.no_grad():
        kernel_ms = cuda_ms(lambda: k2.fused_lstm_scan_inproj_backward(*args, ys, cs, *cots),
                             iters=10, warmup=2)
        plain_ms = cuda_ms(lambda: k2.fused_lstm_scan_inproj_backward_reference(
            *args, ys, cs, *cots), iters=2, warmup=1)
    lib = _cudnn_lstm(args[1], args[2], args[3], dev)
    leaves = (args[0][:, 0].clone().requires_grad_(), args[4].clone().requires_grad_(),
              args[5].clone().requires_grad_())

    def lib_forward():
        return lib(leaves[0], (leaves[1], leaves[2]))

    def lib_forward_backward():
        out, (hN, cN) = lib_forward()
        return torch.autograd.grad(
            (out, hN, cN),
            (*leaves, lib.weight_ih_l0, lib.weight_hh_l0, lib.bias_ih_l0),
            (dys[:, 0], dhT, dcT),
        )

    got = k2.fused_lstm_scan_inproj_backward(*args, ys, cs, *cots)
    print(f"[k2] max |cuDNN dx - kernel dx| {_max_err(lib_forward_backward()[0], got[0][:, 0])}")
    lib_fwd_ms = cuda_ms(lib_forward, iters=10, warmup=2)
    library_ms = cuda_ms(lib_forward_backward, iters=10, warmup=2) - lib_fwd_ms
    bound_ms, bound_by, n_bytes, flops = _k2_bound(T, L, Bb, In, H, backward=True)
    print(f"[k2] backward kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} library_ms "
          f"{library_ms:.4f} (cuDNN forward {lib_fwd_ms:.4f}) bound_ms {bound_ms:.4f} "
          f"({bound_by}: {n_bytes} B, {flops} FLOP); dgates scratch {4 * T * L * Bb * G} B")
    bwd = {
        "name": "fused_lstm_scan_inproj_bwd",
        "route": "cuda",
        "source": "se_tpu_torch/csrc/lstm_inproj.cu",
        "replaces": "se_tpu/ops/pallas_lstm.py:503::_inproj_bwd",
        "max_abs_err": abs_err,
        "max_rel_err": rel_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "scratch_bytes": 4 * T * L * Bb * G,
    }

    # DCCRN's real LSTM at its own shapes, layer 0 (In=1024, chunks of 4
    # steps) then layer 1 (In=256, chunks of 8), H=256: checked at the
    # enhance batch (8) and the card-vs-CPU train batch (2); the forward
    # timed at B=8 on the checked inputs
    dccrn_fwd, dccrn_bwd = {}, {}
    for layer, In_l in ((0, 1024), (1, 256)):
        check(f"DCCRN real l{layer} train", T, 1, 2, In_l, 256)
        a, ys_l, cs_l, cots_l, f_err, b_rel, _ = check(f"DCCRN real l{layer}", T, 1, 8, In_l, 256)
        m = _cudnn_lstm(a[1], a[2], a[3], dev)
        t = _time_scan(
            lambda: k2.fused_lstm_scan_inproj(*a),
            lambda: k2.fused_lstm_scan_inproj_backward(*a, ys_l, cs_l, *cots_l),
            m, (a[0][:, 0], a[4], a[5]), cots_l)
        f_bound = _k2_bound(T, 1, 8, In_l, 256)[0]
        b_bound = _k2_bound(T, 1, 8, In_l, 256, backward=True)[0]
        dccrn_fwd[f"dccrn_real_l{layer}"] = {"ms": t["fwd_ms"], "library_ms": t["lib_fwd_ms"],
                                             "bound_ms": f_bound, "max_abs_err": f_err}
        dccrn_bwd[f"dccrn_real_l{layer}"] = {"ms": t["bwd_ms"], "library_ms": t["lib_bwd_ms"],
                                             "bound_ms": b_bound, "max_rel_err": b_rel}
    print(f"[k2] DCCRN real LSTM at B=8 (T={T}, H=256): forward {dccrn_fwd}; "
          f"backward {dccrn_bwd}")
    fwd.update(dccrn_fwd)
    bwd.update(dccrn_bwd)

    # FullSubNet with the LSTM at its own shapes (T=163: 3 s at hop 300 plus
    # the look-ahead): each layer checked at every batch of its paths, timed
    # beside cuDNN at the enhance batch (B=8)
    fsn_fwd, fsn_bwd = {}, {}
    for label, per_utt, In_l, H_l in _FSN_LAYERS:
        for B in _FSN_TRAIN_BATCHES:
            check(f"FullSubNet {label} B={B}", 163, 1, B * per_utt, In_l, H_l)
        a, ys_l, cs_l, cots_l, f_err, b_rel, _ = check(
            f"FullSubNet {label} B=8", 163, 1, 8 * per_utt, In_l, H_l)
        m = _cudnn_lstm(a[1], a[2], a[3], dev)
        t = _time_scan(
            lambda: k2.fused_lstm_scan_inproj(*a),
            lambda: k2.fused_lstm_scan_inproj_backward(*a, ys_l, cs_l, *cots_l),
            m, (a[0][:, 0], a[4], a[5]), cots_l)
        Bb_l = 8 * per_utt
        fsn_fwd[f"fullsubnet_{label}"] = {"ms": t["fwd_ms"], "library_ms": t["lib_fwd_ms"],
                                          "bound_ms": _k2_bound(163, 1, Bb_l, In_l, H_l)[0],
                                          "max_abs_err": f_err}
        fsn_bwd[f"fullsubnet_{label}"] = {"ms": t["bwd_ms"], "library_ms": t["lib_bwd_ms"],
                                          "bound_ms": _k2_bound(163, 1, Bb_l, In_l, H_l,
                                                                backward=True)[0],
                                          "max_rel_err": b_rel}
    print(f"[k2] FullSubNet LSTM at B=8 (T=163): forward {fsn_fwd}; backward {fsn_bwd}")
    fwd.update(fsn_fwd)
    bwd.update(fsn_bwd)
    return fwd, bwd


def _bf16_errs(got, want, f32_tol) -> dict:
    """A bf16 output against its plain version, element by element: |got -
    want| over one bf16 ulp of max(|got|, |want|) plus ``f32_tol`` (the f32
    form's absolute tolerance, for elements near 0 whose f32 difference
    exceeds their ulp): ``within`` must be at most 1; ``ulps`` is the
    largest |got - want| in ulps alone, ``abs`` in absolute terms;
    ``share`` the share of elements that differ at all."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    mag = torch.maximum(g.abs(), w.abs())
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    return {"within": (d / (ulp + f32_tol)).max().item(),
            "ulps": (d / ulp.clamp_min(torch.finfo(torch.float32).tiny)).max().item(),
            "abs": d.max().item(), "share": (d > 0).float().mean().item()}


def _cudnn_yardstick(modules, inputs, cots,
                     dtypes=(torch.bfloat16, torch.float32)) -> tuple:
    """Yardstick only, never called by the port: CUDA-event times of cuDNN
    LSTM or GRU modules (one per stack) on ``inputs`` ``[(x, h0, c0), ...]``
    (a GRU's ``(x, h0)``): the forward, and forward + backward minus forward
    for ``cots`` ``[(dys, dhT, dcT), ...]`` (a GRU's ``(dys, dhT)``).  In
    the first of ``dtypes`` that cuDNN takes -> ``(fwd_ms, bwd_ms,
    dtype)``."""
    import copy

    from se_tpu_torch.probes import cuda_ms

    state = lambda s: s[0] if len(s) == 1 else tuple(s)  # a GRU's h, an LSTM's (h, c)
    finals = lambda f: f if isinstance(f, tuple) else (f,)
    for dtype in dtypes:
        mods = [copy.deepcopy(m).to(dtype) for m in modules]
        leaves = [[t.to(dtype).clone().requires_grad_() for t in inp] for inp in inputs]
        cot = [[c.to(dtype) for c in cc] for cc in cots]

        def fwd():
            return [m(x, state(s)) for m, (x, *s) in zip(mods, leaves)]

        def fwd_bwd():
            return [torch.autograd.grad((o, *finals(f)), (*lv, *m.parameters()), cc)
                    for m, lv, (o, f), cc in zip(mods, leaves, fwd(), cot)]

        try:
            fwd_bwd()
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"[bf16] cuDNN refused {dtype}: {str(e).splitlines()[0]}")
            continue
        f_ms = cuda_ms(fwd, iters=5, warmup=1)
        return f_ms, cuda_ms(fwd_bwd, iters=5, warmup=1) - f_ms, str(dtype)
    raise RuntimeError(f"cuDNN's RNN ran in none of {dtypes}")


# The bf16 forms' shapes: K1 at DCCRN's (T, L, H) with the enhance batch's
# Bb for the forward and the train batch's for the backward; K2 at (label,
# T, forward Bb, backward Bb, In, H)
_K1_BF16 = (483, 2, 128, 16, 20)
_K2_BF16 = (("CRN", 483, 8, 10, 512, 128), ("FullSubNet sb l0", 163, 2056, 2056, 32, 384),
            ("FullSubNet fb l0", 163, 8, 8, 257, 512))


def phase_bf16_kernels() -> tuple:
    """The bf16-stream forms of K1 and K2 (x_proj or x, ys, dys and the
    stream's gradient bf16; carry, gates, stash and weight gradients f32)
    against their plain versions on the card: K1 at DCCRN's enhance shape
    (forward, Bb=16) and train shape (backward, Bb=20), K2 at CRN's (forward
    B=8, backward B=10), at FullSubNet's sub band, layer 0 (In=32, H=384,
    Bb=2056, T=163, B=8: many rows, the W_hh slice resident) and full band,
    layer 0 (In=257, H=512, Bb=8: the slice streamed); K1 at a ragged case,
    K2 at three (one ``_K2_RAGGED_WAVE``).  Each backward is held
    against the plain backward on the kernel's own saved ys and cs.  Times
    of the bf16 form, of the f32 form on the same values, of the plain
    version and of cuDNN's LSTM (bf16 if it takes it); bounds at bf16
    stream bytes.  Returns the entries K1f-bf16, K1b-bf16, K2f-bf16,
    K2b-bf16."""
    from se_tpu_torch.device import resolve_device
    from se_tpu_torch.probes import cuda_ms
    from se_tpu_torch.ops import fused_lstm as k1
    from se_tpu_torch.ops import fused_lstm_inproj as k2

    dev = resolve_device("cuda")
    rng = np.random.default_rng(SEED + 8)
    bf16, f32 = torch.bfloat16, torch.float32

    def cotangents(T, L, Bb, H):
        dys, dhT, dcT = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
                         for s in ((T, L, Bb, H), (L, Bb, H), (L, Bb, H))]
        return dys.to(bf16), dhT, dcT

    # each module's wrapper, backward, plain backward and gradient names
    calls = {k1: (k1.fused_lstm_scan, k1.fused_lstm_scan_backward,
                  k1.fused_lstm_scan_backward_reference, ("dx_proj", "dw_hh_t", "dh0", "dc0")),
             k2: (k2.fused_lstm_scan_inproj, k2.fused_lstm_scan_inproj_backward,
                  k2.fused_lstm_scan_inproj_backward_reference, _K2B_NAMES)}

    def check(kern, label, stream, rest, cots):
        """Forward (stash-free and with the stash) and backward of the
        bf16 form against the plain versions; two backward calls
        bit-identical.  Returns ys, cs and the errors."""
        fwd_fn, bwd_fn, bwd_ref, names = calls[kern]
        args = (stream, *rest)
        with torch.no_grad():
            ys_n, (hT_n, cT_n) = fwd_fn(*args)
            ys, cs, hT, cT = kern._forward(*args, need_cs=True)
            assert torch.equal(ys_n, ys) and torch.equal(hT_n, hT) and torch.equal(cT_n, cT), \
                f"{label}: the stash changed the forward's results"
            ys_p, cs_p, hT_p, cT_p = kern._reference_forward(*args, need_cs=True)
            got = bwd_fn(*args, ys, cs, *cots)
            again = bwd_fn(*args, ys, cs, *cots)
            want = bwd_ref(*args, ys, cs, *cots)
            torch.cuda.synchronize()
        assert ys.dtype == got[0].dtype == bf16 and all(g.dtype == f32 for g in got[1:]), label
        fwd = {n: _max_err(g, w) for n, g, w in (("cs", cs, cs_p), ("hT", hT, hT_p),
                                                  ("cT", cT, cT_p))}
        ys_e = _bf16_errs(ys, ys_p, KERNEL_TOL)
        dx_e = _bf16_errs(got[0], want[0], BWD_REL_TOL * want[0].abs().max().item())
        rel = {n: _max_err(g, w) / max(w.abs().max().item(), 1e-30)
               for n, g, w in zip(names[1:], got[1:], want[1:])}
        print(f"[bf16] {label}: forward f32 max |kernel - plain| {fwd} (tolerance {KERNEL_TOL}); "
              f"ys bf16 {ys_e}; backward on the kernel's ys and cs: {names[0]} bf16 {dx_e}, "
              f"f32 outputs max |kernel - plain| / max |plain| {rel} (tolerance {BWD_REL_TOL})")
        assert all(np.isfinite(v) and v <= KERNEL_TOL for v in fwd.values()), (label, fwd)
        assert ys_e["within"] <= 1 and dx_e["within"] <= 1, (label, ys_e, dx_e)
        assert all(np.isfinite(v) and v <= BWD_REL_TOL for v in rel.values()), (label, rel)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{label}: not repeatable"
        bwd_abs = max(_max_err(g, w) for g, w in zip(got[1:], want[1:]))
        return ys, cs, {"fwd_abs": max(*fwd.values(), ys_e["abs"]), "ys": ys_e, "dx": dx_e,
                        "bwd_rel": max(rel.values()), "bwd_abs": max(bwd_abs, dx_e["abs"])}

    # K1: the ragged case, then DCCRN's enhance and train shapes
    def k1_case(T, L, Bb, H):
        xp, w, h0, c0 = _scan_inputs(rng, dev, T, L, Bb, H)
        return xp.to(bf16), (w, h0, c0), cotangents(T, L, Bb, H)

    check(k1, "K1 ragged T=7 L=3 Bb=5 H=32", *k1_case(7, 3, 5, 32))
    entries = {}
    T, L, H, Bb_f, Bb_b = _K1_BF16
    G = 4 * H
    for kind, Bb in (("fwd", Bb_f), ("bwd", Bb_b)):
        xp, rest, cots = k1_case(T, L, Bb, H)
        ys, cs, errs = check(k1, f"K1 DCCRN T={T} L={L} Bb={Bb} H={H}", xp, rest, cots)
        w, h0, c0 = rest
        xp32 = xp.float()
        with torch.no_grad():
            if kind == "fwd":
                t = {"ms": cuda_ms(lambda: k1.fused_lstm_scan(xp, *rest), 20, 2),
                     "f32_ms": cuda_ms(lambda: k1.fused_lstm_scan(xp32, *rest), 20, 2),
                     "plain_ms": cuda_ms(lambda: k1.fused_lstm_scan_reference(xp, *rest), 3, 1)}
            else:
                ys32, cs32, _, _ = k1._forward(xp32, *rest, need_cs=True)
                cots32 = (cots[0].float(), *cots[1:])
                t = {"ms": cuda_ms(lambda: k1.fused_lstm_scan_backward(xp, *rest, ys, cs, *cots),
                                   10, 2),
                     "f32_ms": cuda_ms(lambda: k1.fused_lstm_scan_backward(
                         xp32, *rest, ys32, cs32, *cots32), 10, 2),
                     "plain_ms": cuda_ms(lambda: k1.fused_lstm_scan_backward_reference(
                         xp, *rest, ys, cs, *cots), 2, 1)}
        lib_f, lib_b, lib_dtype = _cudnn_yardstick(
            _cuda_lstms(w, dev), [(xp[:, l], h0[l : l + 1], c0[l : l + 1]) for l in range(L)],
            [(cots[0][:, l], cots[1][l : l + 1], cots[2][l : l + 1]) for l in range(L)])
        if kind == "fwd":
            n_bytes = 2 * (xp.numel() + ys.numel()) + 4 * (w.numel() + 4 * h0.numel())
            flops = 2 * T * L * Bb * H * G + T * L * Bb * G
            library_ms, err = lib_f, errs["fwd_abs"]
        else:
            n_bytes = (2 * (2 * xp.numel() + 2 * ys.numel())
                       + 4 * (2 * w.numel() + cs.numel() + 6 * h0.numel()))
            flops = 3 * 2 * T * L * Bb * H * G
            library_ms, err = lib_b, errs["bwd_abs"]
        bound_ms, bound_by = _bound(n_bytes, flops)
        print(f"[bf16] K1{kind[0]} Bb={Bb}: bf16 form {t['ms']:.4f} ms, f32 form {t['f32_ms']:.4f}, "
              f"plain {t['plain_ms']:.4f}, cuDNN ({lib_dtype}) {library_ms:.4f}, bound "
              f"{bound_ms:.4f} ({bound_by}: {n_bytes} B, {flops} FLOP)")
        entries[kind] = {
            "name": f"fused_lstm_scan_{kind}_bf16", "route": "cuda",
            "source": "se_tpu_torch/csrc/lstm_scan.cu",
            "replaces": ("se_tpu/ops/pallas_lstm.py:158::_fwd_call (bf16 stream: :69, :86)"
                         if kind == "fwd" else
                         "se_tpu/ops/pallas_lstm.py:217::_fused_bwd (bf16 stream: :133)"),
            "shapes": f"DCCRN T={T} L={L} Bb={Bb} H={H}",
            "max_abs_err": err, "ys_bf16": errs["ys"], "dx_bf16": errs["dx"],
            "max_rel_err": errs["bwd_rel"], "ms": t["ms"], "kernel_ms": t["ms"],
            "f32_form_ms": t["f32_ms"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "library_dtype": lib_dtype}
    k1f, k1b = entries["fwd"], entries["bwd"]

    # K2: the ragged case, CRN's shapes, then the sub band's layer 0
    def k2_case(T, L, Bb, In, H):
        x, *rest = _inproj_inputs(rng, dev, T, L, Bb, In, H)
        return x.to(bf16), tuple(rest), cotangents(T, L, Bb, H)

    check(k2, "K2 ragged T=7 L=3 Bb=5 In=24 H=32", *k2_case(7, 3, 5, 24, 32))
    check(k2, "K2 ragged tiles and units T=7 L=2 Bb=37 In=20 H=44", *k2_case(7, 2, 37, 20, 44))
    _, T_w, L_w, Bb_w, In_w, H_w = _K2_RAGGED_WAVE
    check(k2, f"K2 ragged wave T={T_w} L={L_w} Bb={Bb_w} In={In_w} H={H_w} "
          f"({_k2_tiling(Bb_w, In_w, H_w, L_w)})", *k2_case(T_w, L_w, Bb_w, In_w, H_w))
    k2f, k2b = {}, {}
    for label, T, Bb_f, Bb_b, In, H in _K2_BF16:
        for kind, Bb in (("fwd", Bb_f), ("bwd", Bb_b)):
            if kind == "fwd" or Bb_b != Bb_f:  # else the forward's case serves
                x, rest, cots = k2_case(T, 1, Bb, In, H)
                ys, cs, errs = check(k2, f"K2 {label} T={T} Bb={Bb} In={In} H={H} "
                                     f"({_k2_tiling(Bb, In, H)})", x, rest, cots)
            w_ih, bias, w_hh, h0, c0 = rest
            x32 = x.float()
            with torch.no_grad():
                if kind == "fwd":
                    t = {"ms": cuda_ms(lambda: k2.fused_lstm_scan_inproj(x, *rest), 5, 1),
                         "f32_ms": cuda_ms(lambda: k2.fused_lstm_scan_inproj(x32, *rest), 5, 1),
                         "plain_ms": cuda_ms(lambda: k2.fused_lstm_scan_inproj_reference(
                             x, *rest), 1, 1)}
                else:
                    ys32, cs32, _, _ = k2._forward(x32, *rest, need_cs=True)
                    cots32 = (cots[0].float(), *cots[1:])
                    t = {"ms": cuda_ms(lambda: k2.fused_lstm_scan_inproj_backward(
                             x, *rest, ys, cs, *cots), 3, 1),
                         "f32_ms": cuda_ms(lambda: k2.fused_lstm_scan_inproj_backward(
                             x32, *rest, ys32, cs32, *cots32), 3, 1),
                         "plain_ms": cuda_ms(lambda: k2.fused_lstm_scan_inproj_backward_reference(
                             x, *rest, ys, cs, *cots), 1, 1)}
                    del ys32, cs32
            lib_f, lib_b, lib_dtype = _cudnn_yardstick(
                [_cudnn_lstm(w_ih, bias, w_hh, dev)], [(x[:, 0], h0, c0)],
                [(cots[0][:, 0], cots[1], cots[2])])
            if kind == "fwd":
                library_ms, err = lib_f, errs["fwd_abs"]
            else:
                library_ms, err = lib_b, errs["bwd_abs"]
            bound_ms, bound_by, n_bytes, flops = _k2_bound(T, 1, Bb, In, H, stream_bytes=2,
                                                           backward=kind == "bwd")
            print(f"[bf16] K2{kind[0]} {label} Bb={Bb}: bf16 form {t['ms']:.4f} ms, f32 form "
                  f"{t['f32_ms']:.4f}, plain {t['plain_ms']:.4f}, cuDNN ({lib_dtype}) "
                  f"{library_ms:.4f}, bound {bound_ms:.4f} ({bound_by}: {n_bytes} B, {flops} FLOP)")
            row = {"ms": t["ms"], "f32_form_ms": t["f32_ms"], "plain_ms": t["plain_ms"],
                   "library_ms": library_ms, "library_dtype": lib_dtype, "bound_ms": bound_ms,
                   "bound_by": bound_by, "max_abs_err": err, "ys_bf16": errs["ys"],
                   "dx_bf16": errs["dx"], "max_rel_err": errs["bwd_rel"]}
            entry = k2f if kind == "fwd" else k2b
            if not entry:  # CRN's numbers head the row
                entry.update(row, kernel_ms=t["ms"], shapes=f"CRN T={T} Bb={Bb} In={In} H={H}")
            else:
                entry[label.lower().replace(" ", "_")] = row
    k2f.update(name="fused_lstm_scan_inproj_fwd_bf16", route="cuda",
               source="se_tpu_torch/csrc/lstm_inproj.cu",
               replaces="se_tpu/ops/pallas_lstm.py:432::_inproj_call (bf16 stream: :318-321, :334)")
    k2b.update(name="fused_lstm_scan_inproj_bwd_bf16", route="cuda",
               source="se_tpu_torch/csrc/lstm_inproj.cu",
               replaces="se_tpu/ops/pallas_lstm.py:503::_inproj_bwd (bf16 stream: :397, :553)")
    return k1f, k1b, k2f, k2b


# K2's bf16 cell-state stash: (label, T, L, Bb, In, H) at CRN's train
# shape, one sub-band layer (layer 0, B = 2: 2 x 257 rows) and the ragged
# wave case
_K2_STASH = (("CRN", 483, 1, 10, 512, 128), ("FullSubNet sb l0 B=2", 163, 1, 514, 32, 384),
             _K2_RAGGED_WAVE)
# bf16 against f32 stash gradients, over each leaf's max: the reference's
# own bound (tests/test_pallas_lstm.py::test_inproj_bf16_cs_stash_grads_close)
STASH_GRAD_TOL = 5e-3


def phase_stash_kernels() -> tuple:
    """K2f and K2b with the bf16 cell-state stash (``cs_dtype=bfloat16``),
    in the f32 and the bf16-stream form, at ``_K2_STASH``'s shapes, against
    their plain versions on the card: the forward's ys, hT and cT bit for bit
    those of the f32-stash forward and its stash those values rounded
    (``cs16 == cs32.to(bf16)``), and within KERNEL_TOL (or one bf16 ulp) of
    the plain forward's; the backward on the kernel's own ys and stash
    against the plain backward by phase 3's K2b rules; its gradients within
    STASH_GRAD_TOL of each leaf's max of the f32-stash backward's; two calls
    of each backward, f32 stash and bf16, bit-identical.  Times at the sub
    band, f32 stream, of the forward with either stash, of K2b with either
    stash, of the plain versions and of cuDNN's LSTM.  Returns the entries
    K2f-cs16 and K2b-cs16."""
    from se_tpu_torch.device import resolve_device
    from se_tpu_torch.probes import cuda_ms
    from se_tpu_torch.ops import fused_lstm_inproj as k2

    dev = resolve_device("cuda")
    rng = np.random.default_rng(SEED + 16)
    bf16, f32 = torch.bfloat16, torch.float32
    fwd = k2._forward
    bwd = k2.fused_lstm_scan_inproj_backward
    rel = lambda got, want: {n: _max_err(g, w) / max(w.abs().max().item(), 1e-30)
                             for n, g, w in zip(_K2B_NAMES, got, want)
                             if g.dtype == f32}
    entries = {}
    for stream in (f32, bf16):
        for label, T, L, Bb, In, H in _K2_STASH:
            x, *rest = _inproj_inputs(rng, dev, T, L, Bb, In, H)
            x = x.to(stream)
            dys, dhT, dcT = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
                             for s in ((T, L, Bb, H), (L, Bb, H), (L, Bb, H))]
            cots = (dys.to(stream), dhT, dcT)
            tag = f"{label} T={T} L={L} Bb={Bb} In={In} H={H}, {str(stream)[6:]} stream"
            with torch.no_grad():
                ys, cs, hT, cT = fwd(x, *rest, need_cs=True, cs_dtype=bf16)
                ys32, cs32, hT32, cT32 = fwd(x, *rest, need_cs=True, cs_dtype=f32)
                assert cs.dtype == bf16 and cs32.dtype == f32, tag
                assert (torch.equal(ys, ys32) and torch.equal(hT, hT32) and torch.equal(cT, cT32)
                        and torch.equal(cs, cs32.to(bf16))), \
                    f"{tag}: the bf16 stash is not the f32 stash rounded, or moved the carry"
                ys_p, cs_p, hT_p, cT_p = k2._reference_forward(x, *rest, True, bf16)
                got = bwd(x, *rest, ys, cs, *cots, cs_dtype=bf16)
                again = bwd(x, *rest, ys, cs, *cots, cs_dtype=bf16)
                want = k2.fused_lstm_scan_inproj_backward_reference(x, *rest, ys, cs, *cots)
                got32 = bwd(x, *rest, ys32, cs32, *cots, cs_dtype=f32)
                again32 = bwd(x, *rest, ys32, cs32, *cots, cs_dtype=f32)
                torch.cuda.synchronize()
            f_errs = {"hT": _max_err(hT, hT_p), "cT": _max_err(cT, cT_p)}
            cs_e = _bf16_errs(cs, cs_p, KERNEL_TOL)
            if stream == f32:
                f_errs["ys"] = _max_err(ys, ys_p)
                ys_e = None
            else:
                ys_e = _bf16_errs(ys, ys_p, KERNEL_TOL)
            b_rel = rel(got, want)
            dx_e = (None if stream == f32 else
                    _bf16_errs(got[0], want[0], BWD_REL_TOL * want[0].abs().max().item()))
            # over each leaf's max; a bf16 dx (the bf16 stream) may round
            # either way besides: its excess over one bf16 ulp of each element
            vs32 = {}
            for n, g, w in zip(_K2B_NAMES, got, got32):
                d = (g.float() - w.float()).abs()
                if g.dtype == bf16:
                    mag = torch.maximum(g.float().abs(), w.float().abs())
                    d = (d - torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
                         ).clamp_min(0)
                vs32[n] = d.max().item() / max(w.float().abs().max().item(), 1e-30)
            print(f"[stash] {tag} ({_k2_tiling(Bb, In, H, L)}): forward bit for bit the f32 "
                  f"stash's, its stash that rounded; against plain: f32 {f_errs} (tolerance "
                  f"{KERNEL_TOL}), cs bf16 {cs_e}" + (f", ys bf16 {ys_e}" if ys_e else "")
                  + f"; backward against plain, f32 outputs over their max {b_rel} (tolerance "
                  f"{BWD_REL_TOL})" + (f", dx bf16 {dx_e}" if dx_e else "")
                  + f"; against the f32 stash's, over each leaf's max (a bf16 dx: beyond one "
                  f"ulp) {vs32} (tolerance {STASH_GRAD_TOL})")
            assert all(np.isfinite(v) and v <= KERNEL_TOL for v in f_errs.values()), (tag, f_errs)
            assert cs_e["within"] <= 1 and (ys_e is None or ys_e["within"] <= 1), (tag, cs_e, ys_e)
            assert all(np.isfinite(v) and v <= BWD_REL_TOL for v in b_rel.values()), (tag, b_rel)
            assert dx_e is None or dx_e["within"] <= 1, (tag, dx_e)
            assert all(np.isfinite(v) and v <= STASH_GRAD_TOL for v in vs32.values()), (tag, vs32)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{tag}: not repeatable"
            assert all(torch.equal(a, b) for a, b in zip(got32, again32)), \
                f"{tag}: the f32 stash's backward not repeatable"
            if stream != f32 or not label.startswith("FullSubNet"):
                continue
            # the sub band, f32 stream: the numbers of the kernels line
            with torch.no_grad():
                t = {"fwd_cs16": cuda_ms(lambda: fwd(x, *rest, True, bf16), 3, 1),
                     "fwd_cs32": cuda_ms(lambda: fwd(x, *rest, True, f32), 3, 1),
                     "bwd_cs16": cuda_ms(lambda: bwd(x, *rest, ys, cs, *cots, cs_dtype=bf16), 3, 1),
                     "bwd_cs32": cuda_ms(lambda: bwd(x, *rest, ys32, cs32, *cots, cs_dtype=f32),
                                         3, 1),
                     "plain_fwd": cuda_ms(lambda: k2._reference_forward(x, *rest, True, bf16), 1, 1),
                     "plain_bwd": cuda_ms(lambda: k2.fused_lstm_scan_inproj_backward_reference(
                         x, *rest, ys, cs, *cots), 1, 1)}
            w_ih, bias, w_hh, h0, c0 = rest
            lib_f, lib_b, lib_dtype = _cudnn_yardstick(
                [_cudnn_lstm(w_ih, bias, w_hh, dev)], [(x[:, 0], h0, c0)],
                [(cots[0][:, 0], cots[1], cots[2])], dtypes=(f32,))
            stash_mb = {"cs16": cs.numel() * 2 / 1e6, "cs32": cs32.numel() * 4 / 1e6}
            print(f"[stash] {tag}: K2f with the bf16 stash {t['fwd_cs16']:.4f} ms, with the f32 "
                  f"stash {t['fwd_cs32']:.4f}; K2b with the bf16 stash {t['bwd_cs16']:.4f} ms, "
                  f"with the f32 stash {t['bwd_cs32']:.4f}; plain {t['plain_fwd']:.4f} and "
                  f"{t['plain_bwd']:.4f}; cuDNN ({lib_dtype}) {lib_f:.4f} and {lib_b:.4f}; "
                  f"stash {stash_mb} MB")
            for kind, ms, ms32, plain_ms, library_ms, err in (
                    ("fwd", t["fwd_cs16"], t["fwd_cs32"], t["plain_fwd"], lib_f,
                     max(*f_errs.values(), cs_e["abs"])),
                    ("bwd", t["bwd_cs16"], t["bwd_cs32"], t["plain_bwd"], lib_b,
                     max(_max_err(g, w) for g, w in zip(got, want)))):
                bound_ms, bound_by, n_bytes, flops = _k2_bound(T, 1, Bb, In, H, stash_bytes=2,
                                                               backward=kind == "bwd")
                entries[kind] = {
                    "name": f"fused_lstm_scan_inproj_{kind}_cs16", "route": "cuda",
                    "source": "se_tpu_torch/csrc/lstm_inproj.cu",
                    "replaces": ("se_tpu/ops/pallas_lstm.py:432::_inproj_call (cs_dtype "
                                 "bfloat16: :38-41, :335, :473)" if kind == "fwd" else
                                 "se_tpu/ops/pallas_lstm.py:503::_inproj_bwd (cs_dtype "
                                 "bfloat16: :362, :377)"),
                    "shapes": tag, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
                    "f32_stash_ms": ms32, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bytes": n_bytes, "library_ms": library_ms,
                    "stash_mb": stash_mb["cs16"], "f32_stash_mb": stash_mb["cs32"]}
    return entries["fwd"], entries["bwd"]


# FullSubNet's two sequence models, two layers each, at 3 s (T = 163):
# (label, rows per utterance, In, H).  The full band runs one row of 257
# bins an utterance (H = 512); the sub band 257 rows of 2 * 15 + 1 noisy and
# 2 * 0 + 1 full-band neighbours (In = 32, H = 384).
_FSN_LAYERS = (("fb l0", 1, 257, 512), ("fb l1", 1, 512, 512),
               ("sb l0", 257, 32, 384), ("sb l1", 257, 384, 384))
# the batches of the train paths besides the enhance batch of 8: the card
# vs CPU step (2) and the 10 steps (the default batch, 10).  At B=10 the
# last row tile is partial: 10 rows in tiles of 4 at the full band, 2570
# in tiles of 16 at the sub band (K2's and K3's wave design, in two
# waves); at B=2 K3 runs the sub band on its per-block kernel, K2 on
# clusters
_FSN_TRAIN_BATCHES = (2, 10)


def _time_scan(fwd, bwd, lib, lib_inputs, cots) -> dict:
    """CUDA-event times of an LSTM scan's forward and backward kernels and
    of the cuDNN ``nn.LSTM`` ``lib`` holding the same weights (a yardstick,
    never on the port's path) on ``lib_inputs`` ``(x, h0, c0)``: its
    forward, and forward + backward minus forward for the cotangents
    ``cots`` ``(dys, dhT, dcT)`` of stack 0."""
    from se_tpu_torch.probes import cuda_ms

    with torch.no_grad():
        fwd_ms = cuda_ms(fwd, iters=3, warmup=1)
        bwd_ms = cuda_ms(bwd, iters=3, warmup=1)
    leaves = [t.clone().requires_grad_() for t in lib_inputs]

    def lib_forward():
        return lib(leaves[0], tuple(leaves[1:]))

    def lib_forward_backward():
        out, final = lib_forward()
        return torch.autograd.grad((out, *final), (*leaves, *lib.parameters()),
                                   (cots[0][:, 0], *cots[1:]))

    lib_fwd_ms = cuda_ms(lib_forward, iters=3, warmup=1)
    lib_bwd_ms = cuda_ms(lib_forward_backward, iters=3, warmup=1) - lib_fwd_ms
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "lib_fwd_ms": lib_fwd_ms,
            "lib_bwd_ms": lib_bwd_ms}


def _gru_inputs(rng, dev, T, L, Bb, In, H):
    """x, w_ih_t, b_ih, w_hh_t, b_hh (torch's init range), nonzero h0."""
    k = 1 / np.sqrt(H)
    host = [
        rng.standard_normal((T, L, Bb, In)),
        rng.uniform(-k, k, (L, In, 3 * H)),
        rng.uniform(-k, k, (L, 3 * H)),
        rng.uniform(-k, k, (L, H, 3 * H)),
        rng.uniform(-k, k, (L, 3 * H)),
        rng.standard_normal((L, Bb, H)) * 0.5,
    ]
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in host]


def _cudnn_gru(w_ih_t, b_ih, w_hh_t, b_hh, dev):
    """Yardstick only, never called by the port: a cuDNN ``nn.GRU(In, H)``
    holding stack 0's weights, which computes the GRU scan's function."""
    In, H = w_ih_t.shape[1], w_hh_t.shape[1]
    m = torch.nn.GRU(In, H).to(dev)
    with torch.no_grad():
        m.weight_ih_l0.copy_(w_ih_t[0].T)
        m.weight_hh_l0.copy_(w_hh_t[0].T)
        m.bias_ih_l0.copy_(b_ih[0])
        m.bias_hh_l0.copy_(b_hh[0])
    return m


_K3B_NAMES = ("dx", "dw_ih_t", "db_ih", "dw_hh_t", "db_hh", "dh0")


def _k3_bound(args, ys, backward) -> tuple:
    """``(bound ms, bound_by, bytes, FLOP)`` of one K3 call on ``args``
    (x, w_ih_t, b_ih, w_hh_t, b_hh, h0) and its ``ys``.  Forward: read x,
    the weights and h0, write ys and hT; backward: read x, ys and dys, the
    weights, h0 and dhT, write dx, the weight gradients and dh0; x, ys, dys
    and dx in the stream's dtype; the products 2 T Bb (In + H) 3H FLOP a
    forward, three times that a backward, at the f32 rate."""
    x, w_ih, b_ih, w_hh, b_hh, h0 = args
    T, _, Bb, In = x.shape
    H = h0.shape[-1]
    n_w = w_ih.numel() + b_ih.numel() + w_hh.numel() + b_hh.numel()
    s = x.element_size()
    flops = 2 * T * Bb * (In + H) * 3 * H
    if backward:
        n_bytes = s * (2 * x.numel() + 2 * ys.numel()) + 4 * (2 * n_w + 3 * h0.numel())
        flops *= 3
    else:
        n_bytes = s * (x.numel() + ys.numel()) + 4 * (n_w + 2 * h0.numel())
    return (*_bound(n_bytes, flops), n_bytes, flops)


def _k3_tiling(Bb, In, H, L=1) -> str:
    """The planner's design for K3's forward and backward scans at a shape:
    on clusters (clusters x CTAs, rows a cluster, units a CTA, chunk steps,
    shared bytes a CTA, and how many such clusters the card runs at once),
    in waves of 16-row CTAs (tiles, clusters of N, waves, ring slabs, x's
    padded rows, shared bytes a CTA and the occupancy query's clusters at
    once), or the per-block kernel."""
    from se_tpu_torch.ops.fused_gru_inproj import active_clusters, plan

    def one(backward):
        p = plan(Bb, In, H, backward, L)
        if p.design == "block":
            return "per-block kernel"
        if p.design == "wave":
            return (f"wave design, {p.tiles} tiles of {p.R} rows a stack in {p.clusters} clusters "
                    f"of {p.N} CTAs, {p.waves} wave(s), ring of {p.stages} slabs, In_p={p.In_p}, "
                    f"Hp={p.Hp}, {p.smem} B, {active_clusters(Bb, In, H, backward, L=L)} "
                    f"clusters at once")
        return (f"{p.tiles} x {p.N} CTAs, R={p.R}, U={p.U}, resident, C={p.C}, {p.smem} B, "
                f"{active_clusters(Bb, In, H, backward, L=L)} clusters at once")

    return f"forward {one(False)}; backward {one(True)}"


def phase_gru_kernels(dtype=torch.float32) -> tuple:
    """fused_gru_scan_inproj (K3f) and its backward (K3b) in the form of the
    stream ``dtype`` against their plain versions, at every shape
    FullSubNet-GRU runs: each of its four layer calls at the train
    comparison's batch (B=2: the sub band on the per-block kernel), the 10
    train steps' (B=10: the wave design in two waves) and the enhance batch
    (B=8: the wave design in one), and four ragged cases (Bb not a multiple
    of the row tile, In odd; three stacks on clusters; 1069 rows at H=64 on
    the per-block kernel; one where neither the rows divide by the
    cluster's tile nor the units by its CTAs; two stacks in the wave design,
    H=200 padded to 224 units), each with the planner's design and tiling
    printed.  Each backward is held on the
    kernel's own ys; two backward calls bit-identical.  In the bf16-stream
    form x, ys, dys and dx are bf16 (each within one bf16 ulp of its plain
    version); the h carry, the gate math, the scratch and the weight, bias
    and state gradients stay f32.  Times at B=8 with cuDNN's ``nn.GRU`` in
    the same dtype beside them (bf16: and the f32 form on the same values);
    the bound from the stream's bytes and the f32 products; the headline
    numbers are the sums over one forward's (or one step's) four calls.
    Returns the K3f and K3b entries of that form."""
    from se_tpu_torch.device import resolve_device
    from se_tpu_torch.probes import cuda_ms
    from se_tpu_torch.ops import fused_gru_inproj as k3

    dev = resolve_device("cuda")
    bf16 = dtype == torch.bfloat16
    tag = "k3 bf16" if bf16 else "k3"
    rng = np.random.default_rng(SEED + (9 if bf16 else 3))

    def check(label, T, L, Bb, In, H):
        """The wrapper's forward against the plain version; the backward
        against its plain version on the kernel's ys.  Returns the inputs,
        ys, seeded cotangents and the errors."""
        x, *rest = _gru_inputs(rng, dev, T, L, Bb, In, H)
        args = (x.to(dtype), *rest)
        dys, dhT = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
                    for s in ((T, L, Bb, H), (L, Bb, H))]
        cots = (dys.to(dtype), dhT)
        with torch.no_grad():
            ys, hT = k3.fused_gru_scan_inproj(*args)
            ys_p, hT_p = k3.fused_gru_scan_inproj_reference(*args)
            got = k3.fused_gru_scan_inproj_backward(*args, ys, *cots)
            again = k3.fused_gru_scan_inproj_backward(*args, ys, *cots)
            want = k3.fused_gru_scan_inproj_backward_reference(*args, ys, *cots)
            torch.cuda.synchronize()
        assert ys.dtype == got[0].dtype == dtype and hT.dtype == torch.float32, label
        assert all(g.dtype == torch.float32 for g in got[1:]), label
        rel = {n: _max_err(g, w) / max(w.abs().max().item(), 1e-30)
               for n, g, w in zip(_K3B_NAMES, got, want)}
        e = {"fwd_abs": max(_max_err(ys, ys_p), _max_err(hT, hT_p)),
             "bwd_abs": max(_max_err(g, w) for g, w in zip(got, want)),
             "bwd_rel": max(rel.values())}
        if bf16:  # the bf16 outputs element by element; hT and the rest as in f32
            e["ys"] = _bf16_errs(ys, ys_p, KERNEL_TOL)
            e["dx"] = _bf16_errs(got[0], want[0], BWD_REL_TOL * want[0].abs().max().item())
            del rel["dx"]
            e["bwd_rel"] = max(rel.values())
            fwd_ok = _max_err(hT, hT_p) <= KERNEL_TOL and e["ys"]["within"] <= 1
            bf16_part = f"; bf16 ys {e['ys']}, dx {e['dx']}"
        else:
            fwd_ok = e["fwd_abs"] <= KERNEL_TOL
            bf16_part = ""
        print(f"[{tag}] {label} T={T} L={L} Bb={Bb} In={In} H={H}: {_k3_tiling(Bb, In, H, L)}; "
              f"forward max |kernel - plain| "
              f"{e['fwd_abs']} (tolerance {KERNEL_TOL}); backward max |kernel - plain| / "
              f"max |plain| {rel} (tolerance {BWD_REL_TOL}), max abs {e['bwd_abs']}{bf16_part}")
        assert np.isfinite(e["fwd_abs"]) and fwd_ok, (label, e)
        assert not bf16 or e["dx"]["within"] <= 1, (label, e["dx"])
        assert all(np.isfinite(v) and v <= BWD_REL_TOL for v in rel.values()), (label, rel)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{label}: backward not repeatable"
        return args, ys, cots, e

    for case in (("ragged", 9, 3, 5, 33, 32), ("ragged 8-row tiles", 9, 1, 1069, 33, 64),
                 ("ragged tiles and units", 7, 2, 37, 20, 44),
                 ("ragged wave, two stacks", 5, 2, 600, 20, 200)):
        check(*case)
    print(f"[{tag}] every case: two backward calls bit-identical")

    T = 163
    keys = ("ms", "f32_ms", "plain_ms", "library_ms", "bytes", "flops")
    tot = {kind: dict.fromkeys(keys, 0.0) for kind in ("fwd", "bwd")}
    worst = {"fwd_abs": 0.0, "bwd_abs": 0.0, "bwd_rel": 0.0, "ys_ulps": 0.0, "dx_ulps": 0.0}
    per_layer, lib_dtype = {}, None
    for label, per_utt, In, H in _FSN_LAYERS:
        for B in _FSN_TRAIN_BATCHES:
            args, ys, _, _ = check(f"{label} B={B}", T, 1, B * per_utt, In, H)
            print(f"[{tag}] {label} B={B}: bound forward {_k3_bound(args, ys, False)[0]} ms, "
                  f"backward {_k3_bound(args, ys, True)[0]} ms")
            del args, ys
        args, ys, cots, e = check(f"{label} B=8", T, 1, 8 * per_utt, In, H)
        worst.update({k: max(worst[k], e[k]) for k in ("fwd_abs", "bwd_abs", "bwd_rel")})
        if bf16:
            worst.update(ys_ulps=max(worst["ys_ulps"], e["ys"]["ulps"]),
                         dx_ulps=max(worst["dx_ulps"], e["dx"]["ulps"]))
        x, w_ih, b_ih, w_hh, b_hh, h0 = args
        with torch.no_grad():
            t = {"fwd": {"ms": cuda_ms(lambda: k3.fused_gru_scan_inproj(*args), 3, 1),
                         "plain_ms": cuda_ms(lambda: k3.fused_gru_scan_inproj_reference(*args),
                                             1, 1)},
                 "bwd": {"ms": cuda_ms(lambda: k3.fused_gru_scan_inproj_backward(
                             *args, ys, *cots), 3, 1),
                         "plain_ms": cuda_ms(lambda: k3.fused_gru_scan_inproj_backward_reference(
                             *args, ys, *cots), 1, 1)}}
            if bf16:  # the f32 form on the same values
                args32, cots32 = (x.float(), *args[1:]), (cots[0].float(), cots[1])
                ys32, _ = k3.fused_gru_scan_inproj(*args32)
                t["fwd"]["f32_ms"] = cuda_ms(lambda: k3.fused_gru_scan_inproj(*args32), 3, 1)
                t["bwd"]["f32_ms"] = cuda_ms(lambda: k3.fused_gru_scan_inproj_backward(
                    *args32, ys32, *cots32), 3, 1)
                del ys32
            else:
                t["fwd"]["f32_ms"], t["bwd"]["f32_ms"] = t["fwd"]["ms"], t["bwd"]["ms"]
        if not bf16:
            with torch.no_grad():
                lib_err = _max_err(_cudnn_gru(w_ih, b_ih, w_hh, b_hh, dev)(x[:, 0], h0)[0],
                                   ys[:, 0])
            print(f"[{tag}] {label}: max |cuDNN GRU - kernel| ys {lib_err}")
        lib_f, lib_b, lib_dtype = _cudnn_yardstick(
            [_cudnn_gru(w_ih, b_ih, w_hh, b_hh, dev)], [(x[:, 0], h0)],
            [(cots[0][:, 0], cots[1])], dtypes=(dtype, torch.float32) if bf16 else (dtype,))
        t["fwd"]["library_ms"], t["bwd"]["library_ms"] = lib_f, lib_b
        for kind in t:
            t[kind]["bound_ms"], _, t[kind]["bytes"], t[kind]["flops"] = _k3_bound(
                args, ys, kind == "bwd")
            t[kind]["design"] = k3.plan(x.shape[2], In, H, kind == "bwd").design
        per_layer[label] = t
        for kind in tot:
            for k in keys:
                tot[kind][k] += t[kind][k]
        print(f"[{tag}] {label} B=8: {t}; cuDNN in {lib_dtype}")

    print(f"[{tag}] scratch at sb l1: {4 * T * 2056 * 4 * 384} B")
    suffix = "_bf16" if bf16 else ""
    common = {"route": "cuda", "source": "se_tpu_torch/csrc/gru_inproj.cu",
              "shapes": "sum of FullSubNet-GRU's four layer calls at B=8 x 3 s (T=163)",
              "library_dtype": lib_dtype}
    entries = {}
    for kind, name, replaces in (
            ("fwd", "fused_gru_scan_inproj_fwd", "se_tpu/ops/pallas_lstm.py:702::_gru_call"
             + (" (bf16 stream: :614, :618, :734)" if bf16 else "")),
            ("bwd", "fused_gru_scan_inproj_bwd", "se_tpu/ops/pallas_lstm.py:762::_gru_bwd"
             + (" (bf16 stream: :643, :667, :807)" if bf16 else ""))):
        t = tot[kind]
        bound_ms, bound_by = _bound(t["bytes"], t["flops"])
        print(f"[{tag}] K3{kind[0]} one FullSubNet-GRU "
              f"{'forward' if kind == 'fwd' else 'step'}'s four calls at B=8: kernel "
              f"{t['ms']:.4f} ms, f32 form {t['f32_ms']:.4f}, plain {t['plain_ms']:.4f}, cuDNN "
              f"({lib_dtype}) {t['library_ms']:.4f}, bound {bound_ms:.4f} ({bound_by}: "
              f"{t['bytes']:.0f} B, {t['flops']:.0f} FLOP)")
        err = {"max_abs_err": worst[f"{kind}_abs"]}
        if kind == "bwd":
            err["max_rel_err"] = worst["bwd_rel"]
        if bf16:
            err[("ys" if kind == "fwd" else "dx") + "_max_ulps"] = worst[
                ("ys" if kind == "fwd" else "dx") + "_ulps"]
        entries[kind] = {"name": name + suffix, "replaces": replaces, **common, **err,
                         "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": t["library_ms"],
                         "per_layer_ms": {k: v[kind]["ms"] for k, v in per_layer.items()},
                         "per_layer_library_ms": {k: v[kind]["library_ms"]
                                                  for k, v in per_layer.items()},
                         "per_layer_bound_ms": {k: v[kind]["bound_ms"]
                                                for k, v in per_layer.items()},
                         "per_layer_plain_ms": {k: v[kind]["plain_ms"]
                                                for k, v in per_layer.items()},
                         "per_layer_design": {k: v[kind]["design"] for k, v in per_layer.items()}}
        if bf16:
            entries[kind].update(f32_form_ms=t["f32_ms"], per_layer_f32_form_ms={
                k: v[kind]["f32_ms"] for k, v in per_layer.items()})
    return entries["fwd"], entries["bwd"]


# DCCRN's six encoder stages: (C, Co, F) of the doubled-batch conv (the
# complex conv's ci input channels, both filter sets' 2 co outputs, and its
# input bins), at kernel_num (32, 64, 128, 256, 256, 256) and 256 bins
_CONV_STAGES = ((1, 32, 256), (16, 64, 128), (32, 128, 64), (64, 256, 32), (128, 256, 16),
                (128, 256, 8))
# K4 vs plain, relative to each output's max |value|: sums of up to 1280 f32
# products (C = 128 x 10 taps) taken in another order than cuDNN's
CONV_REL_TOL = 2e-5


def phase_conv_kernel(dtype=torch.float32) -> dict:
    """fused_complex_conv2d (K4) in the form of ``dtype`` against its plain
    version (cuDNN on the causally padded input) at the six encoder stages
    of the default DCCRN at the enhance batch (B=8: B2=16) and the train
    batch (B=10: B2=20), T=483 frames (3 s), and two ragged cases (C not a
    multiple of 8, Co of neither tile, the second with an odd count of
    positions), also against the plain version on the CPU; two calls
    bit-identical.  The f32 form must equal the plain version (cuDNN on the
    card) and one cuDNN conv of the same function bit for bit.  The bf16
    form takes bf16 x and the f32 w and b, which the wrapper casts to bf16
    (w in its tensor-core layout); it multiplies on the tensor cores, sums
    in f32 and rounds y once (each element within one bf16 ulp of the plain
    version).  Times, with one cuDNN conv of the same
    function in the same dtype beside them (bf16: and the f32 form on the
    same values), at B=8; the bound from the dtype's bytes and its
    products' peak rate (bf16's on the tensor cores); the headline numbers
    are the sums over one forward's six calls."""
    import torch.nn.functional as F

    from se_tpu_torch.device import resolve_device
    from se_tpu_torch.probes import cuda_ms
    from se_tpu_torch.ops import fused_conv

    dev = resolve_device("cuda")
    bf16 = dtype == torch.bfloat16
    tag = "k4 bf16" if bf16 else "k4"
    rng = np.random.default_rng(SEED + (10 if bf16 else 4))
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    T = 483

    def errs(got, want) -> dict:
        scale = want.float().abs().max().item()
        if bf16:
            e = _bf16_errs(got, want, CONV_REL_TOL * scale)
            return {**e, "ok": e["within"] <= 1}
        err = _max_err(got, want)
        return {"abs": err, "rel": err / scale, "ok": err <= CONV_REL_TOL * scale}

    def check(label, B2, C, Co, Fq, T):
        host = (rng.standard_normal((B2, C, Fq, T)), rng.standard_normal((Co, C, 5, 2)) * 0.05,
                rng.standard_normal(Co))
        x, w, b = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in host]
        args = (x.to(dtype), w, b)
        with torch.no_grad():
            got = fused_conv.fused_complex_conv2d(*args)
            again = fused_conv.fused_complex_conv2d(*args)
            want = fused_conv.reference(*args)
            # yardstick, never on the port's path: one cuDNN conv, the time
            # padding on both sides and the extra last frame dropped
            lib = F.conv2d(args[0], w.to(dtype), b.to(dtype), stride=(2, 1), padding=(2, 1))
            torch.cuda.synchronize()
        e = errs(got, want)
        if not bf16:
            e.update(bits_plain=torch.equal(got, want), bits_cudnn=torch.equal(got, lib[..., :T]))
        print(f"[{tag}] {label} B2={B2} C={C} Co={Co} F={Fq} T={T}: y vs plain {e} "
              f"(tolerance {'one bf16 ulp' if bf16 else 'equal bits'})")
        assert got.dtype == dtype and tuple(got.shape) == (B2, Co, Fq // 2, T), label
        assert np.isfinite(e["abs"]) and e["ok"], (label, e)
        assert bf16 or (e["bits_plain"] and e["bits_cudnn"]), (label, e)
        assert torch.equal(got, again), f"{label}: K4 not repeatable"
        return args, got, e

    for label, shape in (("ragged", (3, 3, 40, 20, 37)), ("ragged odd M", (3, 24, 72, 6, 37))):
        args, y, _ = check(label, *shape)
        # the CPU sums in another order than cuDNN, which may match K4's bits
        e = errs(y.cpu(), fused_conv.reference(*(a.cpu() for a in args)))
        print(f"[{tag}] {label}: y vs plain on the CPU {e}")
        assert e["ok"], e
    tot = dict.fromkeys(("ms", "f32_ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops"),
                        0.0)
    worst = {"abs": 0.0, "rel": 0.0, "ulps": 0.0}
    per_stage = {}
    for B in (10, 8):
        for i, (C, Co, Fq) in enumerate(_CONV_STAGES):
            (x, w, b), y, e = check(f"stage {i + 1} B={B}", 2 * B, C, Co, Fq, T)
            worst = {k: max(worst[k], e.get(k, 0.0)) for k in worst}
            if B != 8:
                continue
            x32, wd, bd = x.float(), w.to(dtype), b.to(dtype)
            with torch.no_grad():
                t = {"ms": cuda_ms(lambda: fused_conv.fused_complex_conv2d(x, w, b), 20, 3),
                     "plain_ms": cuda_ms(lambda: fused_conv.reference(x, w, b), 20, 3),
                     # yardstick, never on the port's path: one cuDNN call in
                     # the same dtype, the time padding on both sides and the
                     # extra last frame unread
                     "library_ms": cuda_ms(lambda: F.conv2d(x, wd, bd, stride=(2, 1),
                                                             padding=(2, 1)), 20, 3)}
                t["f32_ms"] = (cuda_ms(lambda: fused_conv.fused_complex_conv2d(x32, w, b), 20, 3)
                               if bf16 else t["ms"])
            s = x.element_size()
            t["bytes"] = s * (x.numel() + w.numel() + b.numel() + y.numel())
            t["flops"] = 2 * y.numel() * 10 * C
            t["bound_ms"] = _bound(t["bytes"], t["flops"], peak)[0]
            per_stage[f"stage {i + 1}"] = t
            for k in tot:
                tot[k] += t[k]
            print(f"[{tag}] stage {i + 1} B=8: {t}")
    bound_by = _bound(tot["bytes"], tot["flops"], peak)[1]
    print(f"[{tag}] one DCCRN forward's six calls at B=8: kernel {tot['ms']:.4f} ms, f32 form "
          f"{tot['f32_ms']:.4f}, plain {tot['plain_ms']:.4f}, cuDNN ({dtype}) "
          f"{tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f} (sum of the stages' bounds at "
          f"{peak / 1e12:.0f} TFLOP/s and {PEAK_BYTES_PER_S / 1e12} TB/s; {tot['bytes']:.0f} B, "
          f"{tot['flops']:.0f} FLOP)")
    entry = {"name": "fused_complex_conv2d_fwd" + ("_bf16" if bf16 else ""), "route": "cuda",
             "source": "se_tpu_torch/csrc/complex_conv.cu",
             "replaces": "se_tpu/ops/pallas_conv.py:88::_pallas_conv"
                         + (" (bf16: :81, :122-123)" if bf16 else ""),
             "shapes": "sum of the default DCCRN's six encoder convs at B=8 x 3 s (T=483)",
             "max_abs_err": worst["abs"], "ms": tot["ms"], "kernel_ms": tot["ms"],
             "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"], "bound_by": bound_by,
             "bound_peak_flops": peak, "library_ms": tot["library_ms"],
             "library_dtype": str(dtype),
             "per_stage_ms": {k: v["ms"] for k, v in per_stage.items()},
             "per_stage_library_ms": {k: v["library_ms"] for k, v in per_stage.items()}}
    if bf16:
        entry.update(y_max_ulps=worst["ulps"], f32_form_ms=tot["f32_ms"],
                     per_stage_f32_form_ms={k: v["f32_ms"] for k, v in per_stage.items()})
    else:
        entry["max_rel_err"] = worst["rel"]
    return entry


# The streaming path's kernel shapes at B = 1 and 100-ms chunks: DCCRN's and
# CRN's 16 frames a chunk at hop 100 (a 3-s file's last chunk holds 3: its
# 300-sample right pad), FullSubNet's 5 at hop 300; label -> (frames a
# chunk, then the wrapper's shape: L, Bb, H for K1; Bb, In, H for K2, K3;
# C, Co, F for K4, whose B2 is 2 and which sees the chunk and the cached
# frame before it)
_STREAM_K1 = (("DCCRN", 16, 2, 2, 128),)
_STREAM_K2 = (("CRN", 16, 1, 512, 128), ("DCCRN-real l0", 16, 1, 1024, 256),
              ("DCCRN-real l1", 16, 1, 256, 256), ("fb l0", 5, 1, 257, 512),
              ("fb l1", 5, 1, 512, 512), ("sb l0", 5, 257, 32, 384), ("sb l1", 5, 257, 384, 384))
_STREAM_K3 = _STREAM_K2[3:]
_STREAM_K4 = tuple((f"stage {i + 1}", 16, *s) for i, s in enumerate(_CONV_STAGES))


def _outs(out) -> tuple:
    """A scan wrapper's ``(ys, state)`` as ``(ys, *state tensors)``."""
    ys, st = out
    return (ys, *(st if isinstance(st, tuple) else (st,)))


def _stream_scan(tag, label, fn, ref, inputs, n_state, T) -> dict:
    """One recurrent kernel at a streaming shape, its last ``n_state``
    inputs the carried state (nonzero): the kernel against its plain
    version at the chunk's T and at T = 1 and 3; the chunk's T steps as two
    calls, the first's final state the second's initial one, against one
    call; the inputs, the state among them, unchanged by every call.
    Returns the worst error and the chunk's times."""
    x, rest = inputs[0], inputs[1:]
    worst = 0.0
    with torch.inference_mode():
        for t in sorted({T, 3, 1}):
            case = (x[:t].contiguous(), *rest)
            held = [a.clone() for a in case]
            got, want = _outs(fn(*case)), _outs(ref(*case))
            torch.cuda.synchronize()
            err = max(_max_err(g, w) for g, w in zip(got, want))
            assert all(torch.equal(a, b) for a, b in zip(case, held)), f"{label} T={t}: inputs"
            print(f"[{tag}] {label} T={t}: max |kernel - plain| {err} (tolerance {KERNEL_TOL})")
            assert np.isfinite(err) and err <= KERNEL_TOL, (label, t, err)
            worst = max(worst, err)
        whole = _outs(fn(*inputs))
        cut = T - 3
        first = _outs(fn(x[:cut].contiguous(), *rest))
        carried = [s.clone() for s in first[1:]]
        second = _outs(fn(x[cut:].contiguous(), *rest[:-n_state], *first[1:]))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first[1:], carried)), f"{label}: state"
        split = (torch.cat([first[0], second[0]]), *second[1:])
        err = max(_max_err(g, w) for g, w in zip(split, whole))
        print(f"[{tag}] {label} T={T} as {cut} + 3 with the state carried: max |two calls - "
              f"one| {err} (tolerance {KERNEL_TOL})")
        assert err <= KERNEL_TOL, (label, err)
    return {"max_abs_err": worst}


def phase_stream_kernels() -> dict:
    """K1f, K2f, K3f and K4 (f32) at the streaming path's shapes
    (``_STREAM_*``): each scan at its chunk's T, at T = 3 (a 3-s file's last
    DCCRN or CRN chunk) and T = 1, from a nonzero state, against its plain
    version, and its chunk as two calls with the state carried; K4 at the
    stage's T + 1 columns (the cached frame and the chunk), 4 and 2, against
    its plain version (cuDNN's bits need not hold at these shapes; relative
    to the output's max, CONV_REL_TOL).  CUDA-event times of each at the
    chunk's T, of its plain version and of the cuDNN call beside it, and its
    bound.  Returns, by kernel, ``{"max_abs_err", "shapes": {label: times}}``."""
    import torch.nn.functional as F

    from se_tpu_torch.device import resolve_device
    from se_tpu_torch.ops import fused_conv
    from se_tpu_torch.ops.fused_gru_inproj import (
        fused_gru_scan_inproj,
        fused_gru_scan_inproj_reference,
    )
    from se_tpu_torch.ops.fused_lstm import fused_lstm_scan, fused_lstm_scan_reference
    from se_tpu_torch.ops.fused_lstm_inproj import (
        fused_lstm_scan_inproj,
        fused_lstm_scan_inproj_reference,
    )
    from se_tpu_torch.probes import cuda_ms

    dev = resolve_device("cuda")
    rng = np.random.default_rng(SEED + 20)
    out = {k: {"max_abs_err": 0.0, "shapes": {}} for k in ("K1f", "K2f", "K3f", "K4")}

    def timed(key, label, kernel, plain, library, n_bytes, flops, err):
        with torch.inference_mode():
            t = {"ms": cuda_ms(kernel, 20, 3), "plain_ms": cuda_ms(plain, 3, 1),
                 "library_ms": cuda_ms(library, 20, 3)}
        t["bound_ms"], t["bound_by"] = _bound(n_bytes, flops)
        out[key]["max_abs_err"] = max(out[key]["max_abs_err"], err)
        out[key]["shapes"][label] = t
        print(f"[stream {key}] {label}: {t}")

    for label, T, L, Bb, H in _STREAM_K1:
        xp, w, h0, c0 = case = _scan_inputs(rng, dev, T, L, Bb, H)
        print(f"[stream K1f] {label} L={L} Bb={Bb} H={H}: {_k1_tiling(L, Bb, H)}")
        e = _stream_scan("stream K1f", label, fused_lstm_scan, fused_lstm_scan_reference, case,
                         2, T)
        lib = _cuda_lstms(w, dev)
        n_bytes = 4 * (xp.numel() + w.numel() + 2 * h0.numel() + T * L * Bb * H + 2 * h0.numel())
        timed("K1f", label, lambda: fused_lstm_scan(*case),
              lambda: fused_lstm_scan_reference(*case),
              lambda: [lib[l](xp[:, l], (h0[l : l + 1], c0[l : l + 1])) for l in range(L)],
              n_bytes, 2 * T * L * Bb * H * 4 * H + T * L * Bb * 4 * H, e["max_abs_err"])
    for label, T, Bb, In, H in _STREAM_K2:
        case = _inproj_inputs(rng, dev, T, 1, Bb, In, H)
        print(f"[stream K2f] {label} Bb={Bb} In={In} H={H}: {_k2_tiling(Bb, In, H)}")
        e = _stream_scan("stream K2f", label, fused_lstm_scan_inproj,
                         fused_lstm_scan_inproj_reference, case, 2, T)
        x, w_ih, bias, w_hh, h0, c0 = case
        lib = _cudnn_lstm(w_ih, bias, w_hh, dev)
        _, _, n_bytes, flops = _k2_bound(T, 1, Bb, In, H)
        timed("K2f", label, lambda: fused_lstm_scan_inproj(*case),
              lambda: fused_lstm_scan_inproj_reference(*case),
              lambda: lib(x[:, 0], (h0, c0)), n_bytes, flops, e["max_abs_err"])
    for label, T, Bb, In, H in _STREAM_K3:
        case = _gru_inputs(rng, dev, T, 1, Bb, In, H)
        print(f"[stream K3f] {label} Bb={Bb} In={In} H={H}: {_k3_tiling(Bb, In, H)}")
        e = _stream_scan("stream K3f", label, fused_gru_scan_inproj,
                         fused_gru_scan_inproj_reference, case, 1, T)
        x, w_ih, b_ih, w_hh, b_hh, h0 = case
        lib = _cudnn_gru(w_ih, b_ih, w_hh, b_hh, dev)
        G = 3 * H
        n_bytes = 4 * (x.numel() + w_ih.numel() + w_hh.numel() + 2 * G + 2 * h0.numel()
                       + T * Bb * H)
        timed("K3f", label, lambda: fused_gru_scan_inproj(*case),
              lambda: fused_gru_scan_inproj_reference(*case), lambda: lib(x[:, 0], h0),
              n_bytes, 2 * T * Bb * (In + H) * G, e["max_abs_err"])
    for label, T, C, Co, Fq in _STREAM_K4:
        host = (rng.standard_normal((2, C, Fq, T + 1)), rng.standard_normal((Co, C, 5, 2)) * 0.05,
                rng.standard_normal(Co))
        x, w, b = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in host]
        worst = 0.0
        with torch.inference_mode():
            for cols in (T + 1, 4, 2):
                xc = x[..., -cols:].contiguous()
                got = fused_conv.fused_complex_conv2d(xc, w, b)
                want = fused_conv.reference(xc, w, b)
                torch.cuda.synchronize()
                err = _max_err(got, want)
                rel = err / want.abs().max().item()
                print(f"[stream K4] {label} B2=2 C={C} Co={Co} F={Fq} T={cols}: max |kernel - "
                      f"plain| {err}, over the output's max {rel} (tolerance {CONV_REL_TOL}); "
                      f"equal bits {torch.equal(got, want)}")
                assert tuple(got.shape) == (2, Co, Fq // 2, cols) and rel <= CONV_REL_TOL, label
                worst = max(worst, err)
        timed("K4", label, lambda: fused_conv.fused_complex_conv2d(x, w, b),
              lambda: fused_conv.reference(x, w, b),
              lambda: F.conv2d(x, w, b, stride=(2, 1), padding=(2, 1)),
              4 * (x.numel() + w.numel() + b.numel() + 2 * Co * (Fq // 2) * (T + 1)),
              2 * 2 * Co * (Fq // 2) * (T + 1) * 10 * C, worst)
    return out


# the probes run at FullSubNet's sub band at B=8 x 3 s, beside K2's rows
PROBE_ARGS = ["8", "163"]
P1_TOL = 1e-5  # f32 modes: of max(1, the output's max |value|); nogates grows
P1_BF16_TOL = 4 * 2.0**-8  # a flipped bf16 rounding in four of a step's values
# bf16gates' outputs differ from real's in nearly every element by bf16
# rounding, and from its own plain version only where a rounding tips:
# the mean distance to its own plain version must be this many times smaller
P1_BF16_SEPARATION = 4
P3_TOL = 1e-5  # of max(1, the output's max): a few f32 ulps; 416-term sums


def _rel(got, want) -> float:
    return _max_err(got, want) / max(1.0, want.abs().max().item())


def phase_probes() -> tuple:
    """The probes' kernels (P1-P3) against their plain versions on the card
    at small shapes and at the sub band's, P1's real mode bit for bit
    against K2 forced onto its cluster design there, P2 also against two
    K2 calls and in two waves, P3's dots-only also at a ragged step count,
    then each probe's own entry
    point (``main`` at B=8, T=163) with every launch count set to 0 just
    before and read just after; the plain versions and the library calls
    timed beside them.  Returns the P1, P2 and P3 entries."""
    from se_tpu_torch.device import resolve_device
    from se_tpu_torch.ops import fused_lstm_inproj as k2
    from se_tpu_torch.probes import bound_probe, cuda_ms, gate_product, vpu_probe, wavefront_probe

    dev = resolve_device("cuda")
    per_utt, In, H = bound_probe.SUB_BAND
    B, T = int(PROBE_ARGS[0]), int(PROBE_ARGS[1])
    Bb = B * per_utt

    # P1: each mode against its plain version at a small shape and at the
    # sub band's; real bit for bit against K2, bf16gates far nearer its own
    # plain version than real's
    small = bound_probe.inputs(12, 10, In, H, dev, seed=SEED + 5)
    small[1] = small[1] * 6  # W_ih N(0, 0.3^2): gates well away from 0
    full = bound_probe.inputs(T, Bb, In, H, dev, seed=SEED)
    p1_errs, at_full = {}, {}
    with torch.no_grad():
        for mode in bound_probe.MODES:
            for args in (small, full):
                got = bound_probe.run(mode, *args)
                want = bound_probe.reference(mode, *args)
                err = max(_rel(g, w) for g, w in zip(got, want))
                p1_errs[mode] = max(p1_errs.get(mode, 0.0), err)
            if mode in ("real", "bf16gates"):
                at_full[mode] = got, want
    print(f"[p1] max |kernel - plain| / max(1, max |plain|) per mode at T=12 Bb=10 and T={T} "
          f"Bb={Bb}: {p1_errs} (tolerance {P1_TOL}; bf16gates {P1_BF16_TOL})")
    assert all(v <= (P1_BF16_TOL if m == "bf16gates" else P1_TOL)
               for m, v in p1_errs.items()), p1_errs
    (ys, hT, cT), (plain_real, _, _) = at_full["real"]
    (bf16_ys, _, _), (plain_bf16, _, _) = at_full["bf16gates"]
    off = (bf16_ys - plain_bf16).abs().mean().item()
    gap = (plain_real - plain_bf16).abs().mean().item()
    print(f"[p1] bf16gates ys at T={T} Bb={Bb}: mean |kernel - plain| {off}, mean |plain real - "
          f"plain bf16gates| {gap} (must be at least {P1_BF16_SEPARATION}x the first)")
    assert off * P1_BF16_SEPARATION <= gap, (off, gap)
    planner = k2.plan  # K2 forced onto its cluster design, P1's kernel
    k2.plan = lambda Bb_, In_, H_, backward=False, L=1: k2.cluster_tiling(Bb_, In_, H_, backward)
    try:
        with torch.no_grad():
            x, wih, b, whh, h0, c0 = full
            k2_ys, (k2_h, k2_c) = k2.fused_lstm_scan_inproj(x[:, None], wih[None], b[None],
                                                            whh[None], h0[None], c0[None])
    finally:
        k2.plan = planner
    assert torch.equal(ys, k2_ys[:, 0]) and torch.equal(hT, k2_h[0]) and torch.equal(cT, k2_c[0])
    print(f"[p1] real mode at T={T} Bb={Bb}: bit-identical with K2 on its cluster design "
          f"({k2.cluster_tiling(Bb, In, H)})")
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: bound_probe.reference("real", *full), 1, 1)
        lstm = _cudnn_lstm(wih[None], b[None], whh[None], dev)
        lib_ms = cuda_ms(lambda: lstm(x, (h0[None], c0[None])), 5, 1)
    del at_full, plain_real, bf16_ys, plain_bf16, k2_ys
    _zero_counts()
    p1_ms = bound_probe.main(PROBE_ARGS)
    p1_launches = _counts()
    print(f"[p1] bound_probe.main({PROBE_ARGS}): launches {p1_launches}")
    assert p1_launches == _expected({"P1": 4 * 21}), p1_launches
    flops = 2 * T * Bb * (In + H) * 4 * H
    n_bytes = 4 * (sum(a.numel() for a in full) + ys.numel() + 2 * hT.numel())
    bound_ms, bound_by = _bound(n_bytes, flops)
    print(f"[p1] real {p1_ms['real']:.4f} ms, plain {plain_ms:.4f}, cuDNN nn.LSTM({In}, {H}) "
          f"{lib_ms:.4f}, bound {bound_ms:.4f} ({bound_by}); ratio to real "
          f"{ {m: p1_ms[m] / p1_ms['real'] for m in bound_probe.MODES} }")
    p1 = {"name": "bound_probe_fwd", "route": "cuda", "source": "se_tpu_torch/csrc/lstm_inproj.cu",
          "replaces": "tools/bound_probe.py:102::run",
          "shapes": f"mode real, the sub band's layer 0 at B={B} (T={T}, Bb={Bb}, In={In}, H={H})",
          "launches": p1_launches["P1"], "max_abs_err": p1_errs["real"],
          "max_err_by_mode": p1_errs, "ms": p1_ms["real"], "kernel_ms": p1_ms["real"],
          "ms_by_mode": p1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "library_ms": lib_ms}

    # P2: against its plain version and two K2 calls at a small shape (a
    # ragged tile of 10 rows) and at a row count that needs a second wave of
    # clusters, two calls bit for bit; its entry point; then the same
    # checks at the sub band's shape, with the plan's clusters held to what
    # the card holds at once
    def p2_check(args):
        T_, Bb_ = args[0].shape[:2]
        with torch.no_grad():
            got = wavefront_probe.wavefront_lstm2(*args)
            again = wavefront_probe.wavefront_lstm2(*args)
            err = max(_max_err(g, w) for g, w in zip(got, wavefront_probe.reference(*args)))
            seq = max(_max_err(g, w) for g, w in zip(got, wavefront_probe.sequential_lstm2(*args)))
        same = all(torch.equal(g, w) for g, w in zip(got, again))
        plan = wavefront_probe.plan(Bb_, In, H)
        fits = wavefront_probe.active_clusters(Bb_, In, H, device=dev)
        print(f"[p2] T={T_} Bb={Bb_} ({plan.tiles} tiles of {plan.R} rows, {plan.clusters} "
              f"clusters of {plan.N}, {plan.waves} wave(s) of at most {fits}, a ring of "
              f"{plan.stages} slabs, {plan.smem} B): max |kernel - plain| {err} (tolerance "
              f"{KERNEL_TOL}); max |kernel - two K2 calls| {seq} (tolerance "
              f"{wavefront_probe.CHECK_TOL}); two calls bit-identical: {same}")
        assert err <= KERNEL_TOL, err
        assert seq <= wavefront_probe.CHECK_TOL, seq
        assert same
        assert fits >= gate_product.CLUSTERS_AT_ONCE[plan.N], (fits, plan)
        assert -(-plan.clusters // plan.waves) <= fits, (fits, plan)
        return err, seq

    inputs = lambda T_, Bb_, seed: wavefront_probe.two_layer_inputs(T_, Bb_, In, H, dev, seed=seed)
    p2_err, seq_err = p2_check(inputs(12, 10, SEED + 6))
    two_wave = 32 * per_utt
    assert wavefront_probe.plan(two_wave, In, H).waves >= 2
    p2_err, seq_err = map(max, zip((p2_err, seq_err), p2_check(inputs(4, two_wave, SEED + 8))))
    _zero_counts()
    p2 = wavefront_probe.main(PROBE_ARGS)
    p2_launches = _counts()
    print(f"[p2] wavefront_probe.main({PROBE_ARGS}): launches {p2_launches}")
    assert p2_launches == _expected({"P2": 1 + 11, "K2f": 2 * (1 + 11)}), p2_launches
    full = inputs(T, Bb, SEED)
    p2_err, seq_err = map(max, zip((p2_err, seq_err), p2_check(full)))
    x, wih1, b1, whh1, wih2, b2, whh2, h0, c0 = full
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: wavefront_probe.reference(*full), 1, 1)
        lstm2 = torch.nn.LSTM(In, H, num_layers=2).to(dev)
        for layer, (wih, b, whh) in enumerate(((wih1, b1, whh1), (wih2, b2, whh2))):
            getattr(lstm2, f"weight_ih_l{layer}").copy_(wih.T)
            getattr(lstm2, f"weight_hh_l{layer}").copy_(whh.T)
            getattr(lstm2, f"bias_ih_l{layer}").copy_(b)
            getattr(lstm2, f"bias_hh_l{layer}").zero_()
        lib_ms = cuda_ms(lambda: lstm2(x, (h0, c0)), 5, 1)
    flops = 2 * T * Bb * (In + 3 * H) * 4 * H
    n_bytes = 4 * (sum(a.numel() for a in full) + 2 * T * Bb * H + 4 * Bb * H)
    bound_ms, bound_by = _bound(n_bytes, flops)
    print(f"[p2] wavefront {p2['wavefront_ms']:.4f} ms, two K2 calls {p2['sequential_ms']:.4f} "
          f"(ratio {p2['sequential_ms'] / p2['wavefront_ms']:.3f}), plain {plain_ms:.4f}, cuDNN "
          f"nn.LSTM({In}, {H}, num_layers=2) {lib_ms:.4f}, bound {bound_ms:.4f} ({bound_by}); "
          f"max |wavefront - two K2 calls| {seq_err}")
    p2 = {"name": "wavefront_lstm2", "route": "cuda", "source": "se_tpu_torch/csrc/wavefront_lstm.cu",
          "replaces": "tools/wavefront_probe.py:94::wavefront_lstm2",
          "shapes": f"the sub band's two layers at B={B} (T={T}, Bb={Bb}, In={In}, H={H})",
          "launches": p2_launches["P2"], "max_abs_err": p2_err, "max_err_vs_sequential": seq_err,
          "ms": p2["wavefront_ms"], "kernel_ms": p2["wavefront_ms"],
          "sequential_ms": p2["sequential_ms"], "plain_ms": plain_ms, "bound_ms": bound_ms,
          "bound_by": bound_by, "library_ms": lib_ms}

    # P3: each op against its plain version on the tile, dots-only also at
    # a step count its launch's groups do not divide, twice for the same
    # bits; then its entry point
    tile = vpu_probe.tile(dev, seed=SEED + 7)
    tiles = -(-Bb // vpu_probe.BB)
    steps = T * tiles
    p3_errs = {}
    with torch.no_grad():
        for op in vpu_probe.OPS:
            got = vpu_probe.run(op, *tile, steps=steps, groups=tiles)
            p3_errs[op] = _rel(got, vpu_probe.reference(op, *tile))
        want = vpu_probe.reference("dots-only", *tile)
        ragged = steps + 1
        plan = vpu_probe.dots_plan(vpu_probe.BB, In, H, ragged)
        assert ragged % plan.groups, plan
        fits = vpu_probe.dots_active_clusters(vpu_probe.BB, In, H, ragged, device=dev)
        assert plan.clusters <= fits, (fits, plan)
        got = vpu_probe.run("dots-only", *tile, steps=ragged)
        again = vpu_probe.run("dots-only", *tile, steps=ragged)
        assert torch.equal(got, again)
        p3_errs["dots-only"] = max(p3_errs["dots-only"], _rel(got, want))
    print(f"[p3] max |kernel - plain| / max(1, max |plain|) per op over {steps} steps (dots-only "
          f"also over {ragged}, in {plan.groups} groups on clusters of {plan.N}): {p3_errs} "
          f"(tolerance {P3_TOL})")
    assert all(v <= P3_TOL for v in p3_errs.values()), p3_errs
    _zero_counts()
    p3_ms = vpu_probe.main(PROBE_ARGS)
    p3_launches = _counts()
    print(f"[p3] vpu_probe.main({PROBE_ARGS}): launches {p3_launches}")
    assert p3_launches == _expected({"P3": 6 * 6, "P1": 6}), p3_launches
    # the volume in one call: the tile broadcast over the steps
    vol = [a.expand(steps, *a.shape) for a in tile[:4]] + tile[4:]
    library = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "exp": torch.exp}
    p3_plain, p3_lib = {}, {}
    with torch.no_grad():
        for op in vpu_probe.OPS:
            p3_plain[op] = cuda_ms(lambda: vpu_probe.reference(op, *vol), 3, 1)
        for op, fn in library.items():
            p3_lib[op] = cuda_ms(lambda: fn(vol[0][..., :H]), 3, 1)
        p3_lib["0.5*tanh+0.5"] = p3_lib["tanh"]
        # gates-only: PyTorch's fused LSTM cell (nn.LSTMCell's kernel on the
        # card; gates i, f, g, o, its second gate input zero), held to the
        # plain version on the tile, then timed on the volume made whole
        cell = lambda g_, c_: torch.ops.aten._thnn_fused_lstm_cell(g_, torch.zeros_like(g_), c_)[0]
        cell_err = _rel(cell(tile[0], tile[1]), vpu_probe.reference("gates-only", *tile))
        assert cell_err <= P3_TOL, cell_err
        g_vol = vol[0].reshape(-1, 4 * H).contiguous()  # rows of the volume: 2-D, as it takes
        c_vol = vol[1].reshape(-1, H).contiguous()
        p3_lib["gates-only"] = cuda_ms(lambda: cell(g_vol, c_vol), 3, 1)
        del g_vol, c_vol
        xh, w = torch.cat(vol[2:4], -1), torch.cat(tile[4:])
        p3_lib["dots-only"] = cuda_ms(lambda: torch.matmul(xh, w), 3, 1)
    bounds = {op: vpu_probe.bound_ms(op, steps) for op in vpu_probe.OPS}
    bound_by = {op: "operations (FP32 FMA)" if op == "dots-only" else
                f"operations ({vpu_probe.bound_pipe(op)})" for op in vpu_probe.OPS}
    shares = {op: bounds[op] / p3_ms[op] for op in vpu_probe.OPS}
    print(f"[p3] {steps} steps of {vpu_probe.BB} x {H}: kernel ms {p3_ms}; plain ms (the volume "
          f"in one call) {p3_plain}; torch ms {p3_lib} (0.5*tanh+0.5 as torch.tanh; gates-only "
          f"as aten._thnn_fused_lstm_cell, {cell_err} from plain on the tile); bound ms {bounds} "
          f"by {bound_by} (each elementwise op's own MUFU and FP32 instructions "
          f"{vpu_probe.PIPE_COUNTS}); share of the bound {shares}")
    p3 = {"name": "vpu_probe", "route": "cuda", "source": "se_tpu_torch/csrc/vpu_probe.cu",
          "replaces": "tools/vpu_probe.py:28::_run",
          "shapes": f"op gates-only, {steps} steps of the {vpu_probe.BB} x {H} tile (the sub band "
                    f"at B={B}, T={T})",
          "launches": p3_launches["P3"], "max_abs_err": p3_errs["gates-only"],
          "max_err_by_op": p3_errs, "ms": p3_ms["gates-only"], "kernel_ms": p3_ms["gates-only"],
          "ms_by_op": p3_ms, "plain_ms": p3_plain["gates-only"], "plain_ms_by_op": p3_plain,
          "bound_ms": bounds["gates-only"], "bound_by": "operations",
          "bound_ms_by_op": bounds, "bound_by_op": bound_by,
          "library_ms": p3_lib["gates-only"], "library_ms_by_op": p3_lib,
          "share_of_bound_by_op": shares,
          "recurrence_ms_same_volume": p3_ms["recurrence"]}
    return p1, p2, p3


# the running statistics of a BatchNorm (the first two) and of a complex
# BatchNorm (the other five)
_RUNNING_STATS = ("running_mean", "running_var", "RMr", "RMi", "RVrr", "RVri", "RVii")


def _grads_and_stats(model) -> tuple:
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    stats = {k: v.detach().cpu() for k, v in model.state_dict().items()
             if k.rsplit(".", 1)[-1] in _RUNNING_STATS}
    return grads, stats


def _leaf_rel_errs(grads, ref, skip, floor=0.0) -> dict:
    """Max |grads - ref| of each leaf over max(its max |ref|, ``floor``),
    leaves in ``skip`` left out."""
    return {k: _max_err(grads[k], g) / max(g.abs().max().item(), floor)
            for k, g in ref.items() if k not in skip}


def _cancelled_by_batch_norm(state_dict) -> set:
    """The biases of a stage's conv (``{section}.{i}.0``: ``*conv.bias``, or
    the bare ``.0.bias`` of CRN's decoder without skip connections) that
    feeds a train-mode BatchNorm, real (``.1.running_mean``) or complex
    (``.1.RMr``): its batch mean removes them, so their exact gradient is 0
    and both devices give roundoff."""
    stage = lambda k: ".".join(k.split(".")[:2])
    return {k for k in state_dict if k.endswith("bias") and k.split(".")[2:3] == ["0"]
            and any(f"{stage(k)}.1.{s}" in state_dict for s in ("running_mean", "RMr"))}


def _counters() -> dict:
    """Every hand kernel form's launch count, by its row in PERF.md's
    table: ``(wrapper, attribute)``.  The bf16 forms of K1-K4 count on their
    own attribute, so a path's exact counts show which form ran."""
    from se_tpu_torch.ops import fused_conv, fused_gru_inproj, fused_lstm, fused_lstm_inproj
    from se_tpu_torch.probes import bound_probe, vpu_probe, wavefront_probe

    k1f, k1b = fused_lstm.fused_lstm_scan, fused_lstm.fused_lstm_scan_backward
    k2f = fused_lstm_inproj.fused_lstm_scan_inproj
    k2b = fused_lstm_inproj.fused_lstm_scan_inproj_backward
    k3f = fused_gru_inproj.fused_gru_scan_inproj
    k3b = fused_gru_inproj.fused_gru_scan_inproj_backward
    k4 = fused_conv.fused_complex_conv2d
    return {"K1f": (k1f, "launches"), "K1b": (k1b, "launches"),
            "K2f": (k2f, "launches"), "K2b": (k2b, "launches"),
            "K3f": (k3f, "launches"), "K3b": (k3b, "launches"), "K4": (k4, "launches"),
            "P1": (bound_probe.run, "launches"), "P2": (wavefront_probe.wavefront_lstm2, "launches"),
            "P3": (vpu_probe.run, "launches"),
            "K1f-bf16": (k1f, "launches_bf16"), "K1b-bf16": (k1b, "launches_bf16"),
            "K2f-bf16": (k2f, "launches_bf16"), "K2b-bf16": (k2b, "launches_bf16"),
            "K3f-bf16": (k3f, "launches_bf16"), "K3b-bf16": (k3b, "launches_bf16"),
            "K4-bf16": (k4, "launches_bf16"),
            # K2's bf16 cell-state stash, in each stream form
            "K2f-cs16": (k2f, "launches_cs16"), "K2b-cs16": (k2b, "launches_cs16"),
            "K2f-bf16-cs16": (k2f, "launches_bf16_cs16"),
            "K2b-bf16-cs16": (k2b, "launches_bf16_cs16")}


def _zero_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def _expected(per_call: dict, calls: int = 1) -> dict:
    """The launch counts of ``calls`` calls that each launch ``per_call``."""
    return {k: calls * per_call.get(k, 0) for k in _counters()}


BF16_CLI = ("--compute-dtype", "bfloat16")


def _paths() -> dict:
    """label -> (config, state dict carried over from a seeded JAX tree,
    launches per forward, launches per backward, enhance CLI arguments)."""
    from se_tpu_torch.config import Config, DccrnConfig
    from se_tpu_torch.utils.weights import (
        random_crn_params,
        random_dccrn_params,
        random_fullsubnet_params,
        state_dict_from_jax,
    )

    dccrn, real = Config(), Config(lstm="real")
    bf16 = lambda cfg: cfg.replace(compute_dtype="bfloat16")
    fused = Config(use_pallas_conv=True)
    crn = Config(model="CRN", loss="MSE", lstm="real", masking_mode="E")  # the tutorial config
    fsn = Config(model="FullSubNet", loss="MSE")
    fsn_gru = fsn.replace(sequence_model="GRU")
    cbn_noskip = Config(dccrn=DccrnConfig(use_cbn=True), skip_type=False, perceptual="LMS")
    crn_noskip = crn.replace(skip_type=False, perceptual="LMS")
    dccrn_sd = state_dict_from_jax(*random_dccrn_params(dccrn, SEED), dccrn)
    return {
        "DCCRN": (dccrn, dccrn_sd,
                  {"K1f": dccrn.dccrn.rnn_layers}, {"K1b": dccrn.dccrn.rnn_layers},
                  ["--model", "DCCRN"]),
        # the default DCCRN's weights, its six encoder convs through K4 (no
        # backward kernel: the convs' gradients are cuDNN's).  No CLI run:
        # neither the JAX package's CLIs nor the port's take this switch
        "DCCRN-fused-conv": (fused, state_dict_from_jax(*random_dccrn_params(fused, SEED), fused),
                             {"K4": len(fused.dccrn.kernel_num), "K1f": fused.dccrn.rnn_layers},
                             {"K1b": fused.dccrn.rnn_layers}, None),
        "CRN": (crn, state_dict_from_jax(*random_crn_params(crn, SEED), crn),
                {"K2f": 1}, {"K2b": 1}, ["--model", "CRN"]),
        "DCCRN-real": (real, state_dict_from_jax(*random_dccrn_params(real, SEED), real),
                       {"K2f": 2}, {"K2b": 2}, ["--model", "DCCRN", "--lstm", "real"]),
        # two layers in each of the full-band and sub-band sequence models
        "FullSubNet": (fsn, state_dict_from_jax(*random_fullsubnet_params(fsn, SEED), fsn),
                       {"K2f": 4}, {"K2b": 4}, ["--model", "FullSubNet"]),
        "FullSubNet-GRU": (fsn_gru, state_dict_from_jax(*random_fullsubnet_params(fsn_gru, SEED),
                                                        fsn_gru),
                           {"K3f": 4}, {"K3b": 4},
                           ["--model", "FullSubNet", "--sequence-model", "GRU"]),
        # compute_dtype="bfloat16" on the f32 paths' weights: the complex
        # LSTM on K1's bf16-stream form, CRN's and FullSubNet's LSTMs on K2's,
        # FullSubNet's GRUs on K3's, the fused encoder convs on K4's bf16
        # form; DCCRN's real LSTM runs in f32 under bf16
        # (se_tpu/models/dccrn.py:215-222), so on K2's f32 form
        "DCCRN-bf16": (bf16(dccrn), state_dict_from_jax(*random_dccrn_params(dccrn, SEED), dccrn),
                       {"K1f-bf16": dccrn.dccrn.rnn_layers},
                       {"K1b-bf16": dccrn.dccrn.rnn_layers},
                       ["--model", "DCCRN", *BF16_CLI]),
        "CRN-bf16": (bf16(crn), state_dict_from_jax(*random_crn_params(crn, SEED), crn),
                     {"K2f-bf16": 1}, {"K2b-bf16": 1}, ["--model", "CRN", *BF16_CLI]),
        "DCCRN-real-bf16": (bf16(real), state_dict_from_jax(*random_dccrn_params(real, SEED), real),
                            {"K2f": 2}, {"K2b": 2},
                            ["--model", "DCCRN", "--lstm", "real", *BF16_CLI]),
        "FullSubNet-bf16": (bf16(fsn), state_dict_from_jax(*random_fullsubnet_params(fsn, SEED),
                                                           fsn),
                            {"K2f-bf16": 4}, {"K2b-bf16": 4},
                            ["--model", "FullSubNet", *BF16_CLI]),
        "FullSubNet-GRU-bf16": (bf16(fsn_gru), state_dict_from_jax(
                                    *random_fullsubnet_params(fsn_gru, SEED), fsn_gru),
                                {"K3f-bf16": 4}, {"K3b-bf16": 4},
                                ["--model", "FullSubNet", "--sequence-model", "GRU", *BF16_CLI]),
        # no CLI run, as for DCCRN-fused-conv
        "DCCRN-fused-conv-bf16": (bf16(fused), state_dict_from_jax(
                                      *random_dccrn_params(fused, SEED), fused),
                                  {"K4-bf16": len(fused.dccrn.kernel_num),
                                   "K1f-bf16": fused.dccrn.rnn_layers},
                                  {"K1b-bf16": fused.dccrn.rnn_layers}, None),
        # the trainer variants and model switches, each on K1 or K2 as its
        # network runs them.  The first three train the default DCCRN's
        # weights (no enhance phase: their forward is the default DCCRN's,
        # or, in direct mode, needs the targets)
        "DCCRN-PMSQE": (dccrn.replace(perceptual="PMSQE"), dccrn_sd,
                        {"K1f": dccrn.dccrn.rnn_layers}, {"K1b": dccrn.dccrn.rnn_layers}, None),
        "DCCRN-LMS-bf16": (bf16(dccrn.replace(perceptual="LMS")), dccrn_sd,
                           {"K1f-bf16": dccrn.dccrn.rnn_layers},
                           {"K1b-bf16": dccrn.dccrn.rnn_layers}, None),
        # MSE: SDR along time is log10(0) on the spectra's rows that are 0
        # in every frame (the DC and Nyquist bins' imaginary parts)
        "DCCRN-direct": (dccrn.replace(masking_mode="Direct(None make)", loss="MSE"), dccrn_sd,
                         {"K1f": dccrn.dccrn.rnn_layers}, {"K1b": dccrn.dccrn.rnn_layers}, None),
        "DCCRN-cbn-noskip": (cbn_noskip, state_dict_from_jax(
                                 *random_dccrn_params(cbn_noskip, SEED), cbn_noskip),
                             {"K1f": cbn_noskip.dccrn.rnn_layers},
                             {"K1b": cbn_noskip.dccrn.rnn_layers},
                             ["--model", "DCCRN", "--use-cbn", "--no-skip"]),
        "CRN-noskip-LMS": (crn_noskip, state_dict_from_jax(
                               *random_crn_params(crn_noskip, SEED), crn_noskip),
                           {"K2f": 1}, {"K2b": 1}, None),
    }


# paths that only train (phase 5): no enhance phase
TRAIN_ONLY = ("DCCRN-PMSQE", "DCCRN-LMS-bf16", "DCCRN-direct", "CRN-noskip-LMS")


def phase_train(label: str, cfg, sd, per_fwd: dict, per_bwd: dict, steps: int) -> tuple:
    """A train path at full width: one step at B=2 on the card and on the CPU
    from the same weights, launch counts read around it.  With ``steps``,
    also a step with gradient accumulation and the main path: that many
    steps at the default batch on one fixed batch (``_train_steps``).
    Returns the launches of the B=2 step and of the main path (None with no
    ``steps``)."""
    from se_tpu_torch.train.state import create_train_state
    from se_tpu_torch.train.steps import train_step

    noisy, clean = _utterances(cfg.train.batch, 3, cfg.stft.fs)
    noisy, clean = noisy[:2], clean[:2]
    per_step = {**per_fwd, **per_bwd}
    train_cfg = cfg  # the main path: FullSubNet with its dropout
    if cfg.model == "FullSubNet":  # two devices draw different dropout masks
        cfg = cfg.replace(fullsubnet=dataclasses.replace(cfg.fullsubnet, dropout=0.0))
    bf16 = cfg.compute_dtype == "bfloat16"

    # counts read around one train step
    model, opt = create_train_state(cfg, sd, device="cuda")
    _zero_counts()
    metrics = train_step(cfg, model, opt, noisy, clean)
    torch.cuda.synchronize()
    launches = _counts()
    print(f"[train {label}] train_step B=2: launches {launches}")
    assert launches == _expected(per_step), launches
    grads, stats = _grads_and_stats(model)

    cpu_model, cpu_opt = create_train_state(cfg, sd, device="cpu")
    cpu_metrics = train_step(cfg, cpu_model, cpu_opt, noisy, clean)
    cpu_grads, cpu_stats = _grads_and_stats(cpu_model)
    loss_tol = BF16_LOSS_TOL if bf16 else TRAIN_LOSS_TOL
    # the perceptual variant's two terms beside the loss, each held alike
    for key in metrics:
        loss, cpu_loss = metrics[key].item(), cpu_metrics[key].item()
        loss_err = abs(loss - cpu_loss) / max(1.0, abs(cpu_loss))
        what = f"{cfg.loss} loss" if key == "loss" else key
        print(f"[train {label}] {what} card {loss} cpu {cpu_loss}: relative {loss_err} "
              f"(tolerance {loss_tol})")
        assert np.isfinite(loss) and loss_err <= loss_tol, (key, loss, cpu_loss)
    cancelled = _cancelled_by_batch_norm(sd)
    scale = max(g.abs().max().item() for g in cpu_grads.values())
    report = [("card vs cpu, over the leaf's max", _leaf_rel_errs(grads, cpu_grads, cancelled))]
    if steps:  # the card against itself: a second step from the same weights
        model2, opt2 = create_train_state(cfg, sd, device="cuda")
        train_step(cfg, model2, opt2, noisy, clean)
        report.append(("card vs card rerun, over the leaf's max",
                       _leaf_rel_errs(_grads_and_stats(model2)[0], grads, cancelled)))
    if bf16:
        rel = _leaf_rel_errs(grads, cpu_grads, (), GRAD_FLOOR * scale)
        lstm = {k: v for k, v in rel.items() if k.startswith(_BOTTLENECK)}
        report.append((f"card vs cpu, over max(leaf's max, {GRAD_FLOOR} x {scale:.4g})", rel))
        report.append(("the bottleneck's leaves, the same", lstm))
        fsn = cfg.model == "FullSubNet"
        grad_tol = FSN_BF16_GRAD_TOL if fsn else BF16_GRAD_TOL
        lstm_tol = FSN_BF16_LSTM_GRAD_TOL if fsn else BF16_LSTM_GRAD_TOL
        lstm_key = max(lstm, key=lstm.get)
        print(f"[train {label}] bf16: worst bottleneck leaf {lstm_key} {lstm[lstm_key]:.3g} "
              f"(tolerance {lstm_tol})")
        assert lstm[lstm_key] <= lstm_tol, (lstm_key, lstm[lstm_key])
    else:
        for k in cancelled:
            assert max(grads[k].abs().max().item(),
                       cpu_grads[k].abs().max().item()) <= 1e-5 * scale, k
        rel = _leaf_rel_errs(grads, cpu_grads, cancelled, GRAD_FLOOR * scale)
        report.append((f"card vs cpu, over max(leaf's max, {GRAD_FLOOR} x {scale:.4g})", rel))
        print(f"[train {label}] {len(cancelled)} BatchNorm-cancelled conv biases at roundoff "
              f"(<= 1e-5 of the largest gradient)")
        grad_tol = TRAIN_GRAD_TOL
        if label in ILL_CONDITIONED:
            assert all(torch.isfinite(g).all() for g in grads.values())
            card, cpu, nudged = _cotangent_grads(cfg, sd, noisy, clean)
            rel = _leaf_rel_errs(card, cpu, cancelled, GRAD_FLOOR * scale)
            spread = _leaf_rel_errs(nudged, cpu, cancelled, GRAD_FLOOR * scale)
            key = max(spread, key=spread.get)
            grad_tol = max(TRAIN_GRAD_TOL, CONDITION_FACTOR * spread[key])
            report.append(("card vs cpu for the CPU loss's cotangents of the outputs, over "
                           f"max(leaf's max, {GRAD_FLOOR} x {scale:.4g})", rel))
            print(f"[train {label}] conditioning: for those cotangents, the CPU's gradients from "
                  f"an input one rounding away move {key} by {spread[key]:.3g}; card vs cpu "
                  f"held to max({TRAIN_GRAD_TOL}, {CONDITION_FACTOR} x {spread[key]:.3g}) = "
                  f"{grad_tol:.3g}")
    for what, errs in report:
        top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
        print(f"[train {label}] gradients, {what}: worst "
              + ", ".join(f"{k} {v:.3g} (max {cpu_grads[k].abs().max().item():.3g})"
                          for k, v in top) + f"; tolerance {grad_tol}")
    worst_key = max(rel, key=rel.get)
    assert rel[worst_key] <= grad_tol, (worst_key, rel[worst_key])
    stats_err = max((_max_err(stats[k], cpu_stats[k]) for k in stats), default=0.0)
    stats_tol = BF16_STATS_TOL if bf16 else TRAIN_STATS_TOL
    print(f"[train {label}] running statistics, card vs cpu: max |diff| {stats_err} "
          f"(tolerance {stats_tol})")
    assert stats_err <= stats_tol, stats_err
    if not steps:
        return launches, None

    accum = cfg.replace(train=dataclasses.replace(cfg.train, grad_accum=2))
    _zero_counts()
    train_step(accum, model, opt, noisy, clean)
    torch.cuda.synchronize()
    print(f"[train {label}] train_step B=2 grad_accum=2: launches {_counts()}")
    assert _counts() == _expected(per_step, 2), _counts()
    return launches, _train_steps(label, train_cfg, sd, per_step, steps)


def _cotangent_grads(cfg, sd, noisy, clean) -> tuple:
    """The parameter gradients of train-mode forwards from ``sd``, each for
    the same cotangents of the model's outputs, those of the train step's
    loss on the CPU: on the card, on the CPU, and on the CPU from ``noisy``
    with each sample moved by a relative 2^-23 x N(0, 1), one f32 rounding.
    -> (card, CPU, nudged CPU) gradients by parameter name, on the host."""
    from se_tpu_torch.train.state import create_train_state
    from se_tpu_torch.train.steps import _loss_and_outputs, trainer_variant

    rng = np.random.default_rng(SEED + 1)
    nudged = (noisy * (1 + 2.0**-23 * rng.standard_normal(noisy.shape))).astype(np.float32)
    grads, cots = {}, None
    for run, dev, x in (("cpu", "cpu", noisy), ("card", "cuda", noisy), ("nudged", "cpu", nudged)):
        model, _ = create_train_state(cfg, sd, device=dev)
        model.train()
        outs = []
        model.register_forward_hook(lambda m, args, out: outs.extend(out))
        on = next(model.parameters()).device
        x, y = (torch.as_tensor(a, device=on) for a in (x, clean))
        if cots is None:
            loss, _, _ = _loss_and_outputs(cfg, trainer_variant(cfg), model, x, y)
            live = [i for i, o in enumerate(outs) if o is not None and o.requires_grad]
            cots = torch.autograd.grad(loss, [outs[i] for i in live], retain_graph=True,
                                       allow_unused=True)
            cots = [torch.zeros_like(outs[i]) if c is None else c for i, c in zip(live, cots)]
        else:
            model(x, y)
        names, params = zip(*model.named_parameters())
        g = torch.autograd.grad([outs[i] for i in live], params, [c.to(on) for c in cots])
        grads[run] = {k: v.detach().cpu() for k, v in zip(names, g)}
    return grads["card"], grads["cpu"], grads["nudged"]


def _train_steps(label: str, cfg, sd, per_step: dict, steps: int = 10) -> dict:
    """The main train path: ``steps`` steps at the default batch on one fixed
    batch, every count set to 0 just before and read just after; the loss
    must fall (FullSubNet, whose dropout makes each step's loss noisy: the
    batch's dropout-free loss, before and after).  Step time, throughput,
    peak memory and a profile.  Returns the launches."""
    from se_tpu_torch.train.state import create_train_state
    from se_tpu_torch.train.steps import eval_step, train_step

    B, seconds = cfg.train.batch, 3
    noisy, clean = _utterances(B, seconds, cfg.stft.fs)
    model, opt = create_train_state(cfg, sd, device="cuda")
    # FullSubNet's dropout masks come from a generator on the card
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(SEED)
    train_step(cfg, model, opt, noisy, clean, gen)  # warm-up: cuDNN's algorithm choice
    model, opt = create_train_state(cfg, sd, device="cuda")
    dropout = cfg.model == "FullSubNet"
    before = eval_step(cfg, model, noisy, clean)[0]["loss"].item() if dropout else None
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    metrics = []
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics.append(train_step(cfg, model, opt, noisy, clean, gen))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    main_launches = _counts()
    losses = [m["loss"].item() for m in metrics]
    print(f"[train {label}] {steps} steps at B={B} x {seconds} s: launches {main_launches}, "
          f"losses {losses}")
    if "perceptual_loss" in metrics[0]:
        print(f"[train {label}] {cfg.loss} and {cfg.perceptual} terms, first and last step: "
              + ", ".join(f"{m['main_loss'].item()} and {m['perceptual_loss'].item()}"
                          for m in (metrics[0], metrics[-1])))
    assert main_launches == _expected(per_step, steps), main_launches
    print(f"[train {label}] {1e3 * step_s:.3f} ms per step, {B / step_s:.2f} utterances/s, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    assert all(np.isfinite(losses)), losses
    if dropout:
        after = eval_step(cfg, model, noisy, clean)[0]["loss"].item()
        print(f"[train {label}] dropout-free {cfg.loss} loss of the batch: {before} before "
              f"the {steps} steps, {after} after")
        assert after < before, (before, after)
    else:
        assert losses[-1] < losses[0], losses
    if cfg.train.adam_mu_dtype is not None:
        mus = {st["mu"].dtype for st in opt.state.values()}
        print(f"[train {label}] Adam's first moments stored as {mus}")
        assert mus == {getattr(torch, cfg.train.adam_mu_dtype)}, mus
    _profile(lambda: train_step(cfg, model, opt, noisy, clean, gen), steps=PROFILE_CALLS, top=16)
    return main_launches


def _utterances(n: int, seconds: int, fs: int) -> tuple:
    """(noisy, clean) [n, seconds * fs]: amplitude-modulated harmonic
    stacks plus white noise, from SEED."""
    rng = np.random.default_rng(SEED)
    t = np.arange(seconds * fs) / fs
    clean = []
    for _ in range(n):
        f0 = rng.uniform(100, 250)
        sig = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi)) / k
                  for k in range(1, 8))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
        clean.append(0.3 * env * sig / np.abs(sig).max())
    clean = np.stack(clean).astype(np.float32)
    noisy = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    return noisy, clean


def phase_stash_train(paths: dict) -> dict:
    """One CRN train step at B=2 with K2's bf16 cell-state stash on
    (``CS_STASH_DTYPE`` as ``SE_TPU_LSTM_CS_STASH=bfloat16`` sets it), on the
    card and on the CPU from the same weights, by phase 5's f32 rules
    (``phase_train``): K2f-cs16 and K2b-cs16 launch once each, the f32-stash
    forms not at all.  Returns the launches."""
    from se_tpu_torch.ops import fused_lstm_inproj as k2

    cfg, sd, _, _, _ = paths["CRN"]
    saved, k2.CS_STASH_DTYPE = k2.CS_STASH_DTYPE, torch.bfloat16
    try:
        launches, _ = phase_train("CRN-cs16", cfg, sd, {"K2f-cs16": 1}, {"K2b-cs16": 1}, steps=0)
    finally:
        k2.CS_STASH_DTYPE = saved
    return launches


def phase_remat(paths: dict) -> dict:
    """``remat_convs`` on the card: for the default DCCRN and for
    DCCRN-fused-conv, one ``train_step`` at the default batch (B=10) with
    ``remat_convs=True`` against the same step without it, from the same
    weights: the loss and the running statistics by phase 5's f32 rules,
    each gradient leaf by the data-parallel phase's (over max(its max,
    GRAD_FLOOR x the largest), within TRAIN_GRAD_TOL; the BatchNorm-cancelled
    conv biases at roundoff), each BatchNorm's ``num_batches_tracked`` at 1,
    the launches exact (the recompute runs each encoder stage's K4 again:
    12 a step on the fused conv; K1f and K1b 2 each); the peak device memory
    of each step.  Returns ``{label: the remat step's launches}``."""
    from se_tpu_torch.train.state import create_train_state
    from se_tpu_torch.train.steps import train_step

    out = {}
    for label in ("DCCRN", "DCCRN-fused-conv"):
        cfg, sd, per_fwd, per_bwd, _ = paths[label]
        noisy, clean = _utterances(cfg.train.batch, 3, cfg.stft.fs)
        runs = {}
        for remat in (False, True):
            c = cfg.replace(remat_convs=remat)
            model, opt = create_train_state(c, sd, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # weights and Adam's state
            _zero_counts()
            loss = train_step(c, model, opt, noisy, clean)["loss"].item()
            torch.cuda.synchronize()
            grads, stats = _grads_and_stats(model)
            runs[remat] = {"loss": loss, "grads": grads, "stats": stats, "launches": _counts(),
                           "peak": torch.cuda.max_memory_allocated(), "held": held,
                           "tracked": {v.item() for k, v in model.state_dict().items()
                                       if k.endswith("num_batches_tracked")}}
            del model, opt
        plain, rem = runs[False], runs[True]
        per_step = {**per_fwd, **per_bwd}
        twice = {k: (2 * v if k.startswith("K4") else v) for k, v in per_step.items()}
        loss_err = abs(rem["loss"] - plain["loss"]) / max(1.0, abs(plain["loss"]))
        cancelled = _cancelled_by_batch_norm(sd)
        scale = max(g.abs().max().item() for g in plain["grads"].values())
        rel = _leaf_rel_errs(rem["grads"], plain["grads"], cancelled, GRAD_FLOOR * scale)
        worst = max(rel, key=rel.get)
        near = max(max(rem["grads"][k].abs().max().item(), plain["grads"][k].abs().max().item())
                   for k in cancelled)
        stats_err = max(_max_err(rem["stats"][k], v) for k, v in plain["stats"].items())
        mib = lambda r: (r["peak"] / 2**20, (r["peak"] - r["held"]) / 2**20)
        nonzero = lambda launches: {k: v for k, v in launches.items() if v}
        print(f"[remat {label}] train_step B={cfg.train.batch} with remat_convs against without: "
              f"loss {rem['loss']} and {plain['loss']} (relative {loss_err:.3g}, tolerance "
              f"{TRAIN_LOSS_TOL}); gradients over max(leaf's max, {GRAD_FLOOR} x {scale:.4g}) "
              f"worst {worst} {rel[worst]:.3g} (tolerance {TRAIN_GRAD_TOL}), {len(cancelled)} "
              f"cancelled conv biases at most {near:.3g}; running statistics max |diff| "
              f"{stats_err:.3g} (tolerance {TRAIN_STATS_TOL}); num_batches_tracked "
              f"{rem['tracked']} and {plain['tracked']}; launches {nonzero(rem['launches'])} and "
              f"{nonzero(plain['launches'])}; peak device memory (MiB; beyond the weights and Adam's "
              f"state) {mib(rem)} with remat, {mib(plain)} without")
        assert plain["launches"] == _expected(per_step), plain["launches"]
        assert rem["launches"] == _expected(twice), rem["launches"]
        assert np.isfinite(rem["loss"]) and loss_err <= TRAIN_LOSS_TOL, loss_err
        assert rel[worst] <= TRAIN_GRAD_TOL and near <= 1e-5 * scale, (worst, rel[worst], near)
        assert stats_err <= TRAIN_STATS_TOL, stats_err
        assert rem["tracked"] == plain["tracked"] == {1}, (rem["tracked"], plain["tracked"])
        out[label] = {"launches": rem["launches"], "peak_mib": mib(rem)[0],
                      "peak_mib_without": mib(plain)[0]}
    return out


# the EMA norms' tolerance, card against CPU, over the output's max: the
# frame means summed in another order, then 163 dependent steps
NORM_TOL = 1e-5


def phase_fsn_init_and_norms() -> dict:
    """FullSubNet with ``weight_init=True`` at full width (its init table
    drawn on the host from a generator seeded SEED + 1): one forward at
    B=2 on 1-s utterances on the card and on the CPU from the same build,
    the cRM within SLICE_TOL of its max; then each EMA norm
    (``forgetting_norm``, ``sband_forgetting_norm``, ``hybrid_norm``, their
    sample length 100 frames, so that each runs past its warm-up) on a
    ``[2, 257, 163]`` tensor on the card against the CPU, within NORM_TOL
    of the output's max.  Returns the errors."""
    from se_tpu_torch.config import Config, FullSubNetConfig
    from se_tpu_torch.dsp.stft import stft
    from se_tpu_torch.models import build_model
    from se_tpu_torch import ops

    cfg = Config(model="FullSubNet", loss="MSE", fullsubnet=FullSubNetConfig(weight_init=True))
    s = cfg.stft
    noisy, _ = _utterances(2, 1, s.fs)
    mag = stft(torch.from_numpy(noisy), s.fft_len, s.torch_hop, s.win_len).abs()
    with torch.inference_mode():
        cpu = build_model(cfg, device="cpu", seed=SEED)(mag)
        card = build_model(cfg, device="cuda", seed=SEED)(mag.cuda()).cpu()
    errs = {"cRM": _max_err(card, cpu) / cpu.abs().max().item()}
    x = torch.from_numpy(np.abs(np.random.default_rng(SEED + 17).standard_normal(
        (2, 257, 163))).astype(np.float32) + 0.01)
    for name in ("forgetting_norm", "sband_forgetting_norm", "hybrid_norm"):
        fn = getattr(ops, name)
        want = fn(x, 100)
        errs[name] = _max_err(fn(x.cuda(), 100).cpu(), want) / want.abs().max().item()
    print(f"[fsn] FullSubNet weight_init=True B=2 forward cRM {tuple(cpu.shape)} and the EMA "
          f"norms on [2, 257, 163]: max |card - cpu| over the output's max {errs} (tolerances "
          f"{SLICE_TOL} and {NORM_TOL})")
    assert np.isfinite(errs["cRM"]) and errs["cRM"] <= SLICE_TOL, errs
    assert all(np.isfinite(v) and v <= NORM_TOL for k, v in errs.items() if k != "cRM"), errs
    return errs


def phase_slice(label: str, cfg, sd, per_forward: dict) -> tuple:
    """An enhance path at full width: ``enhance_batch`` on 8 three-second
    utterances (the main path: every count set to 0 just before, read just
    after), the validation forward, speed and a profile, then the same
    weights on the CPU.  Returns the main path's launches and its enhanced
    waveform on the host."""
    from se_tpu_torch.enhance import enhance_batch
    from se_tpu_torch.models import build_model
    from se_tpu_torch.train.steps import eval_step

    fs, B, seconds = cfg.stft.fs, 8, 3
    model = build_model(cfg, device="cuda")
    model.load_state_dict(sd, strict=True)
    noisy, clean = _utterances(B, seconds, fs)

    # the main path: counts read around one enhance_batch call
    _zero_counts()
    wav = enhance_batch(model, noisy)
    torch.cuda.synchronize()
    launches = _counts()
    print(f"[slice {label}] enhance_batch [{B}, {seconds * fs}] -> {list(wav.shape)}, "
          f"launches {launches}")
    assert launches == _expected(per_forward), launches
    assert tuple(wav.shape) == noisy.shape and torch.isfinite(wav).all()
    if cfg.model != "FullSubNet":  # DCCRN and CRN clip; FullSubNet does not
        assert wav.abs().max().item() <= 1.0

    _zero_counts()
    metrics, eval_wav = eval_step(cfg, model, noisy, clean)
    torch.cuda.synchronize()
    assert _counts() == _expected(per_forward), _counts()
    # cuDNN need not repeat its sums bit for bit from one call to the next
    rerun_err = _max_err(eval_wav, wav)
    print(f"[slice {label}] eval_step wav vs enhance_batch wav: max |diff| {rerun_err}")
    assert rerun_err <= 1e-5, rerun_err

    reps = 5  # batches timed: few, for the script's time
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        enhance_batch(model, noisy)
    torch.cuda.synchronize()
    per_batch = (time.perf_counter() - t0) / reps
    print(f"[slice {label}] {B * reps} utterances in {per_batch * reps:.4f} s: "
          f"{B / per_batch:.2f} utt/s, real-time factor {per_batch / (B * seconds):.6f}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    _profile(lambda: enhance_batch(model, noisy), steps=PROFILE_CALLS)

    cpu_model = build_model(cfg, device="cpu")
    cpu_model.load_state_dict(sd, strict=True)
    cpu_metrics, cpu_wav = eval_step(cfg, cpu_model, noisy, clean)
    err = _max_err(wav.cpu(), cpu_wav)
    mean_err = (wav.cpu() - cpu_wav).abs().mean().item()
    loss, cpu_loss = metrics["loss"].item(), cpu_metrics["loss"].item()
    bf16 = cfg.compute_dtype == "bfloat16"
    tol, mean_tol, loss_tol = ((BF16_SLICE_TOL, BF16_SLICE_MEAN_TOL, BF16_LOSS_TOL) if bf16
                               else (SLICE_TOL, SLICE_TOL, 1e-3))
    loss_err = abs(loss - cpu_loss) / max(1.0, abs(cpu_loss))
    print(f"[slice {label}] |card - cpu| wav max {err} (tolerance {tol}), mean {mean_err} "
          f"(tolerance {mean_tol}); {cfg.loss} loss card {loss} cpu {cpu_loss}: relative "
          f"{loss_err} (tolerance {loss_tol})")
    assert err <= tol and mean_err <= mean_tol, (err, mean_err)
    assert np.isfinite(loss) and loss_err <= loss_tol, (loss, cpu_loss)
    return launches, wav.cpu()


# The streaming paths (phase 4b), each on an f32 path's weights: DCCRN's
# complex and real LSTMs and its K4 encoder, CRN, and both FullSubNets, each
# with a cumulative norm (they hold no parameters, so the weights serve).
# label -> (the path whose config and weights it takes, FullSubNet's norm)
STREAM_PATHS = {"DCCRN": ("DCCRN", None), "DCCRN-real": ("DCCRN-real", None),
                "DCCRN-fused-conv": ("DCCRN-fused-conv", None), "CRN": ("CRN", None),
                "FullSubNet": ("FullSubNet", "cumulative_laplace_norm"),
                "FullSubNet-GRU": ("FullSubNet-GRU", "cumulative_layer_norm")}
STREAM_CHUNK_MS = 100
# the streamed waveform against the batch forward over the whole utterance:
# the JAX package's own streaming tolerance (tests/test_streaming.py)
STREAM_TOL = 2e-4


def _stream_paths(paths: dict) -> dict:
    """label -> (config, state dict, launches per model call)."""
    out = {}
    for label, (base, norm) in STREAM_PATHS.items():
        cfg, sd, per_fwd, _, _ = paths[base]
        if norm:
            cfg = cfg.replace(fullsubnet=dataclasses.replace(cfg.fullsubnet, norm_type=norm))
        out[label] = (cfg, sd, per_fwd)
    return out


def _runs(items: list) -> list:
    """``items`` as ``[(item, how many in a row), ...]``."""
    runs = []
    for item in items:
        if runs and runs[-1][0] == item:
            runs[-1][1] += 1
        else:
            runs.append([item, 1])
    return runs


def phase_stream(label: str, cfg, sd, per_call: dict) -> dict:
    """A streaming path at full width: one 3-s utterance at B = 1 through
    ``stream_chunks`` in chunks of STREAM_CHUNK_MS, once to warm up, then
    again with every count set to 0 just before and read after each step
    (a step: a chunk, and at the end the conv-STFT's pad or FullSubNet's
    look-ahead frames, the decoder's flush, the overlap-add's last samples):
    each step that runs the model on any frame launches ``per_call``, the
    flush steps nothing.  Each step is timed on the host clock to
    ``synchronize`` (the chunk's latency); the real-time factor and the peak
    device memory.  The enhanced waveform against ``enhance_batch`` on the
    same weights over the whole utterance, within STREAM_TOL.  Returns the
    readings."""
    from se_tpu_torch.device import resolve_device
    from se_tpu_torch.enhance import chunk_samples, enhance_batch, stream_chunks, stream_output
    from se_tpu_torch.models import build_model
    from se_tpu_torch.models.factory import build_stream_model

    fs, seconds = cfg.stft.fs, 3
    dev = resolve_device("cuda")
    wav = torch.from_numpy(_utterances(1, seconds, fs)[0]).to(dev)  # [1, L]
    batch = build_model(cfg, device=dev)
    batch.load_state_dict(sd, strict=True)
    model = build_stream_model(cfg, device=dev)
    model.load_state_dict(sd, strict=True)
    chunk = chunk_samples(cfg, STREAM_CHUNK_MS)
    pieces = wav.split(chunk, dim=-1)
    fsn = cfg.model == "FullSubNet"
    hop = cfg.stft.torch_hop if fsn else cfg.stft.win_inc
    lag = model.look_ahead if fsn else model.n_stages
    list(stream_chunks(model, pieces))  # warm-up: cuDNN's algorithm choice
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    outs, step_ms, deltas = [], [], []
    before = _counts()
    t0 = time.perf_counter()
    steps = stream_chunks(model, pieces)
    while True:
        t_step = time.perf_counter()
        y = next(steps, None)
        if y is None:
            break
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t_step))
        now = _counts()
        deltas.append({k: now[k] - before[k] for k in now if now[k] != before[k]})
        before = now
        outs.append(y)
    wall = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    got = stream_output(model, torch.cat(outs, dim=-1), wav.shape[-1])[0]
    want = enhance_batch(batch, wav, dev)[0]
    err = _max_err(got, want)

    # the model runs on every chunk and on the end's frames (the conv-STFT's
    # pad; FullSubNet's last analysis frames and its look-ahead zeros); the
    # decoder's flush and the overlap-add's last samples launch nothing
    flushes = 1 if fsn else 2
    calls = len(pieces) + 1
    expected = [per_call] * calls + [{}] * flushes
    chunk_ms = np.array(step_ms[: len(pieces)])
    p50, p99 = np.percentile(chunk_ms, 50), np.percentile(chunk_ms, 99)
    print(f"[stream {label}] {seconds} s at B=1 in {len(pieces)} chunks of {chunk} samples "
          f"({chunk // hop} frames; algorithmic latency {lag} frames = {1e3 * lag * hop / fs:.1f} "
          f"ms), {len(step_ms)} steps: launches {launches}, per step "
          + ", ".join(f"{d} x {n}" for d, n in _runs(deltas)))
    print(f"[stream {label}] chunk latency p50 {p50:.3f} ms, p99 {p99:.3f} ms, max "
          f"{chunk_ms.max():.3f} ms (host clock to synchronize); the end's steps "
          f"{[round(t, 3) for t in step_ms[len(pieces):]]} ms; {wall:.4f} s for {seconds} s: "
          f"real-time factor {wall / seconds:.6f}; peak device memory {peak:.1f} MiB")
    print(f"[stream {label}] streamed wav vs enhance_batch over the whole utterance: max |diff| "
          f"{err} (tolerance {STREAM_TOL}); {tuple(got.shape)} vs {tuple(want.shape)}")
    assert deltas == expected, (deltas, expected)
    assert launches == _expected(per_call, calls), launches
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert err <= STREAM_TOL, err
    return {"launches": launches, "launches_per_chunk": per_call, "chunks": len(pieces),
            "model_calls": calls, "p50_ms": p50, "p99_ms": p99, "rtf": wall / seconds,
            "peak_mib": peak, "max_abs_err": err, "wav": got.cpu()}


def phase_cli(workdir: Path, paths: dict, held_to: dict = None, streams: dict = None):
    """The enhance CLI on the card for every path that has CLI arguments,
    each in a process of its own, all started at once (nothing is timed
    meanwhile): 3 files of 3, 2.5 and 1.25 s at ``--batch 2``, each output
    held to ``enhance_batch`` in this process on the buffers the CLI should
    build, batched as the CLI batches them and one row at a time; a path in
    ``held_to`` (label -> ``phase_slice``'s waveform of the 8 utterances)
    also holds its 3-s file, the first utterance, to that waveform's first
    row.  Every process is waited for, or killed.  Meanwhile each path in
    ``streams`` (label -> (config, state dict)) runs the CLI's ``main`` in
    this process with ``--streaming`` (``_stream_cli``)."""
    from se_tpu_torch.data.wav import write_wav
    from se_tpu_torch.utils.weights import save_reference_checkpoint

    jobs = {}
    try:
        for label, (cfg, sd, _, _, cli_args) in paths.items():
            if cli_args is None:
                continue
            fs = cfg.stft.fs
            noisy, _ = _utterances(8, 3, fs)
            run_dir = workdir / label
            run_dir.mkdir()
            ckpt = save_reference_checkpoint(str(run_dir / "checkpoint.pt"), sd)
            n = noisy.shape[1]  # 48000: files of 3, 2.5 and 1.25 s
            lengths = {"a.wav": n, "b.wav": n * 5 // 6, "c.wav": n * 5 // 12}
            for i, (name, L) in enumerate(lengths.items()):
                write_wav(str(run_dir / name), noisy[i, :L], fs)
            cmd = [sys.executable, "-m", "se_tpu_torch.enhance", "--checkpoint", ckpt, *cli_args,
                   "--batch", "2", "--device", "cuda",
                   *[str(run_dir / n) for n in lengths], "--out-dir", str(run_dir / "enhanced")]
            jobs[label] = (subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True), lengths)
        for label, (cfg, sd) in (streams or {}).items():
            _stream_cli(workdir / f"stream-{label}", label, cfg, sd)
        for label, (proc, lengths) in jobs.items():
            stdout, stderr = proc.communicate(timeout=600)
            print(stdout.strip())
            assert proc.returncode == 0, stderr[-3000:]
            cfg, sd, _, _, cli_args = paths[label]
            _check_cli(workdir / label, label, cfg, sd, cli_args, lengths)
            if label in (held_to or {}):
                _check_cli_against_slice(workdir / label, label, held_to[label])
    finally:
        for proc, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _check_cli(run_dir: Path, label: str, cfg, sd, cli_args, lengths: dict):
    """One CLI run's outputs against ``enhance_batch`` in this process."""
    from se_tpu_torch.data.wav import read_wav
    from se_tpu_torch.enhance import enhance_batch
    from se_tpu_torch.models import build_model

    fs = cfg.stft.fs
    model = build_model(cfg, device="cuda")
    model.load_state_dict(sd, strict=True)
    # FullSubNet with an offline norm (an utterance-global statistic) needs
    # room for fft_len / 2 reflected samples past the end
    offline = cfg.model == "FullSubNet" and cfg.fullsubnet.norm_type.startswith("offline")
    margin = cfg.stft.fft_len // 2 if offline else 0
    bufs = {}
    for name, L in lengths.items():
        # the buffer the CLI should build, made here on its own: zero padded
        # to whole seconds; with the offline norm, the first fft_len / 2 pad
        # samples reflect the tail, x[L + k] = x[L - 2 - k], and the frames
        # from 1 + L // torch_hop on are masked
        x = read_wav(str(run_dir / name))[0].astype(np.float32)
        buf = np.zeros(-(-(L + margin) // fs) * fs, np.float32)
        buf[:L] = x
        frames = None
        if margin:
            buf[L : L + margin] = x[L - 1 - margin : L - 1][::-1]
            frames = np.array([1 + L // cfg.stft.torch_hop])
        bufs[name] = buf, frames
    # the CLI's own batches: files of one buffer length in argument order, two
    # rows a batch, the last padded by repeating its last row
    by_length, batched = {}, {}
    for name, (buf, _) in bufs.items():
        by_length.setdefault(len(buf), []).append(name)
    for names in by_length.values():
        for i in range(0, len(names), 2):
            rows = names[i : i + 2] + names[i : i + 2][-1:] * (2 - len(names[i : i + 2]))
            frames = None if margin == 0 else np.concatenate([bufs[n][1] for n in rows])
            y = enhance_batch(model, np.stack([bufs[n][0] for n in rows]), valid_frames=frames)
            batched.update(zip(names[i : i + 2], y.cpu().numpy()))
    to_int16 = lambda y: np.clip(y * 32768, -32768, 32767).astype(np.int16) / 32768.0
    worst_batch = worst_single = 0.0
    for name, L in lengths.items():
        buf, frames = bufs[name]
        single = enhance_batch(model, buf[None], valid_frames=frames)[0, :L].cpu().numpy()
        got = read_wav(str(run_dir / "enhanced" / name))[0]
        assert got.shape == (L,), got.shape
        worst_batch = max(worst_batch, float(np.abs(got - to_int16(batched[name][:L])).max()))
        worst_single = max(worst_single, float(np.abs(got - to_int16(single)).max()))
    # a row's bf16 result depends on its batch's size: cuDNN picks its
    # algorithms by shape, and where two f32 sums differ in their last bit a
    # bf16 rounding tips, as between two devices
    single_tol = BF16_SLICE_TOL if cfg.compute_dtype == "bfloat16" else CLI_TOL
    print(f"[cli {label}] {' '.join(cli_args)}: max |CLI - in-process| on the CLI's batches "
          f"{worst_batch * 32768:.1f} LSB (tolerance 2 LSB), one row at a time "
          f"{worst_single * 32768:.1f} LSB (tolerance {single_tol * 32768:.0f} LSB)")
    assert worst_batch <= CLI_TOL and worst_single <= single_tol, (worst_batch, worst_single)


def _stream_cli(run_dir: Path, label: str, cfg, sd) -> None:
    """The enhance CLI's ``main`` in this process (as phase 7 runs the train
    CLI's), ``--streaming --chunk-ms`` STREAM_CHUNK_MS on one 3-s file, its
    output held to ``enhance_stream`` on the file the CLI read, at the CLI's
    int16 rounding: within CLI_TOL."""
    from se_tpu_torch import enhance
    from se_tpu_torch.data.wav import read_wav, write_wav
    from se_tpu_torch.enhance import chunk_samples, enhance_stream
    from se_tpu_torch.models.factory import build_stream_model
    from se_tpu_torch.utils.weights import save_reference_checkpoint

    run_dir.mkdir()
    ckpt = save_reference_checkpoint(str(run_dir / "checkpoint.pt"), sd)
    write_wav(str(run_dir / "a.wav"), _utterances(1, 3, cfg.stft.fs)[0][0], cfg.stft.fs)
    cli_args = ["--model", cfg.model, "--streaming", "--chunk-ms", str(STREAM_CHUNK_MS)]
    if cfg.model == "FullSubNet":
        cli_args += ["--sequence-model", cfg.sequence_model, "--fsn-norm",
                     cfg.fullsubnet.norm_type]
    elif cfg.lstm == "real":
        cli_args += ["--lstm", "real"]
    enhance.main(["--checkpoint", ckpt, *cli_args, "--device", "cuda", str(run_dir / "a.wav"),
                  "--out-dir", str(run_dir / "enhanced")])
    model = build_stream_model(cfg, device="cuda")
    model.load_state_dict(sd, strict=True)
    x = read_wav(str(run_dir / "a.wav"))[0].astype(np.float32)
    want = enhance_stream(model, x, chunk_samples(cfg, STREAM_CHUNK_MS)).cpu().numpy()
    want = np.clip(want * 32768, -32768, 32767).astype(np.int16) / 32768.0
    got = read_wav(str(run_dir / "enhanced" / "a.wav"))[0]
    err = float(np.abs(got - want).max())
    print(f"[cli stream {label}] {' '.join(cli_args)}: max |CLI - in-process stream| "
          f"{err * 32768:.1f} LSB (tolerance 2 LSB)")
    assert got.shape == want.shape and err <= CLI_TOL, (got.shape, err)


def _check_cli_against_slice(run_dir: Path, label: str, wav) -> None:
    """The CLI's 3-s file (``_utterances``' first row, its own batch of two
    with the 2.5-s file) against ``phase_slice``'s enhanced waveform of that
    row in a batch of 8, at the CLI's int16 rounding: within CLI_TOL."""
    from se_tpu_torch.data.wav import read_wav

    got = read_wav(str(run_dir / "enhanced" / "a.wav"))[0]
    want = np.clip(wav[0].numpy() * 32768, -32768, 32767).astype(np.int16) / 32768.0
    err = float(np.abs(got - want).max())
    print(f"[cli {label}] a.wav against phase_slice's first row: max {err * 32768:.1f} LSB "
          f"(tolerance 2 LSB)")
    assert got.shape == want.shape and err <= CLI_TOL, (got.shape, err)


def _dp_readings(cfg, sd, noisy, clean, steps: int, mesh=None, device="cuda") -> dict:
    """``steps`` train steps of the global batch ``(noisy, clean)`` on the
    card from ``sd``: on this rank's rows with ``parallel_train_step`` under
    ``mesh``, else on all of them with ``train_step``; every count set to 0
    just before the steps and read just after -> numpy ``losses``, the first
    step's ``grads`` and ``stats``, the ``final`` leaves (the state dict's and
    Adam's moments, as ``<param> exp_avg``), ``launches`` and ``ms`` a
    step after the first (a step on a model thrown away first takes cuDNN's
    warm-up)."""
    from se_tpu_torch.data.dataset import WaveDataset
    from se_tpu_torch.data.multihost import MultiHostLoader
    from se_tpu_torch.parallel.dp import parallel_train_step
    from se_tpu_torch.train.state import create_train_state
    from se_tpu_torch.train.steps import train_step

    dev = device if mesh is None else mesh.device
    if mesh is not None:
        loader = MultiHostLoader(WaveDataset(np.stack([noisy, clean], 1)), len(noisy), mesh.rank,
                                 mesh.world, shuffle=False, grad_accum=cfg.train.grad_accum)
        noisy, clean = next(iter(loader))

    def step(model, opt):
        if mesh is None:
            return train_step(cfg, model, opt, noisy, clean)
        return parallel_train_step(cfg, model, opt, mesh, noisy, clean)

    step(*create_train_state(cfg, sd, device=dev))
    model, opt = create_train_state(cfg, sd, device=dev)
    out = {"losses": []}
    torch.cuda.synchronize()
    _zero_counts()
    for s in range(steps):
        out["losses"].append(step(model, opt)["loss"].item())
        if s == 0:
            grads, stats = _grads_and_stats(model)
            # copies: on the CPU (a rehearsal) .cpu() returns the live buffer
            out["grads"] = {k: v.numpy().copy() for k, v in grads.items()}
            out["stats"] = {k: v.numpy().copy() for k, v in stats.items()}
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    out["ms"] = 1e3 * (time.perf_counter() - t0) / max(steps - 1, 1)
    out["launches"] = _counts()
    final = {k: v.cpu().numpy().copy() for k, v in model.state_dict().items()
             if v.is_floating_point()}
    state = opt.state_dict()["state"]  # keyed by the parameter's index
    for i, (name, _) in enumerate(model.named_parameters()):
        final.update({f"{name} {k}": v.cpu().numpy().copy() for k, v in state[i].items()
                      if torch.is_tensor(v) and v.ndim})
    out["final"] = final
    return out


def _dp_rank(cfg, sd, noisy, clean, steps: int, device: str) -> dict:
    """One rank of phase 6b, in a process of its own (``phase_dp_start``)."""
    from se_tpu_torch.parallel.mesh import destroy, make_mesh

    # every rank on the one card: gloo, as NCCL takes one rank a card
    mesh = make_mesh("cuda:0" if device == "cuda" else device, backend="gloo")
    try:
        return _dp_readings(cfg, sd, noisy, clean, steps, mesh)
    finally:
        destroy(mesh)


def _dp_batch(cfg) -> tuple:
    return _utterances(cfg.train.batch, 3, cfg.stft.fs)


def phase_dp_start(cfg, sd, device="cuda"):
    """Start phase 6b: DP_WORLD ranks spawned on the one card, each running
    ``_dp_rank`` on its rows of ``_dp_batch``; returns the future of their
    readings.  Each rank gets two BLAS threads: two ranks' OpenBLAS pools
    spinning on the same cores slow the conv-STFT's pseudo-inverse tenfold."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from se_tpu_torch.parallel.launch import spawn

    os.environ["OPENBLAS_NUM_THREADS"] = "2"  # read by each spawned process at its start
    noisy, clean = _dp_batch(cfg)
    sd = {k: v.cpu() for k, v in sd.items()}
    pool = ThreadPoolExecutor(1)
    future = pool.submit(spawn, _dp_rank, DP_WORLD, (cfg, sd, noisy, clean, DP_STEPS, device),
                         600.0)
    pool.shutdown(wait=False)
    return future


def phase_dp_check(future, cfg, sd, per_step: dict, device="cuda") -> list:
    """Phase 6b's check: the ranks' readings against the one-process step,
    each rank's launches exact (``per_step`` a step, nothing else).  The
    yardstick is the one-process step with its batch's halves swapped: the
    same sums in another order, which is all that parts the ranks from one
    process.  Returns each rank's launches."""
    noisy, clean = _dp_batch(cfg)
    one = _dp_readings(cfg, sd, noisy, clean, DP_STEPS, device=device)
    half = len(noisy) // 2
    swap = np.r_[half : len(noisy), 0:half]
    swapped = _dp_readings(cfg, sd, noisy[swap], clean[swap], DP_STEPS, device=device)
    ranks = future.result()
    B, lr = cfg.train.batch, cfg.train.learning_rate
    print(f"[dp] {DP_WORLD} ranks (gloo, one card) x {B // DP_WORLD} rows against one process "
          f"x {B} rows, {DP_STEPS} steps of {cfg.model}: ms a step after the first "
          f"{[round(r['ms'], 3) for r in ranks]} against {one['ms']:.3f}; launches "
          f"{[r['launches'] for r in ranks]}")
    expected = _expected(per_step, DP_STEPS)
    assert all(r["launches"] == expected for r in ranks), ([r["launches"] for r in ranks], expected)
    assert one["launches"] == expected, one["launches"]
    got = ranks[0]
    for r in ranks[1:]:
        assert r["losses"] == got["losses"], (r["losses"], got["losses"])
        for k, v in got["final"].items():
            assert np.array_equal(v, r["final"][k]), k
    loss_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(got["losses"], one["losses"]))
    print(f"[dp] losses {got['losses']} against {one['losses']}: relative {loss_err:.3g} "
          f"(tolerance {TRAIN_LOSS_TOL})")
    to_t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    ref = to_t(one["grads"])
    cancelled = _cancelled_by_batch_norm(sd)
    scale = max(g.abs().max().item() for g in ref.values())
    rel = _leaf_rel_errs(to_t(got["grads"]), ref, cancelled, GRAD_FLOOR * scale)
    spread = _leaf_rel_errs(to_t(swapped["grads"]), ref, cancelled, GRAD_FLOOR * scale)
    grad_tol = max(TRAIN_GRAD_TOL, CONDITION_FACTOR * max(spread.values()))
    worst = max(rel, key=rel.get)
    near = max(max(np.abs(got["grads"][k]).max(), np.abs(one["grads"][k]).max())
               for k in cancelled)
    stats_err = max(_max_err(torch.from_numpy(v), torch.from_numpy(one["stats"][k]))
                    for k, v in got["stats"].items())
    print(f"[dp] first step's gradients, over max(leaf's max, {GRAD_FLOOR} x {scale:.4g}): worst "
          f"{worst} {rel[worst]:.3g}; the one process with its halves swapped moves "
          f"{max(spread, key=spread.get)} by {max(spread.values()):.3g}; tolerance max("
          f"{TRAIN_GRAD_TOL}, {CONDITION_FACTOR} x that) = {grad_tol:.3g}; {len(cancelled)} "
          f"BatchNorm-cancelled conv biases at most {near:.3g} (<= 1e-5 x {scale:.4g}); running "
          f"statistics max |diff| {stats_err:.3g} (tolerance {TRAIN_STATS_TOL})")
    bns = {".".join(k.split(".")[:2]) + ".1" for k in cancelled}
    apart = {k for k in got["final"] if k.split(" ")[0] in cancelled
             or (k.rsplit(".", 1)[0] in bns and k.endswith(("running_mean", "RMr", "RMi")))}

    def final_errs(run):
        return {k: _max_err(torch.from_numpy(v), torch.from_numpy(one["final"][k]))
                for k, v in run["final"].items()}

    final, final_spread = final_errs(got), final_errs(swapped)
    top = lambda k: max(np.abs(one["final"][k]).max(), 1e-30)
    # each leaf over its max, to max(RESUME_LEAF_TOL, CONDITION_FACTOR x the
    # swapped run's reading of it): a PReLU slope's gradient sums millions of
    # terms of both signs, and Adam's moments of it move by tens of percent
    leaf_tol = {k: max(RESUME_LEAF_TOL, CONDITION_FACTOR * final_spread[k] / top(k))
                for k in final if k not in apart}
    over = {k: final[k] / top(k) / tol for k, tol in leaf_tol.items()}
    worst_leaf = max(over, key=over.get)
    worst_near = max(apart, key=final.get)
    bound = _adam_bound(lr, DP_STEPS)
    print(f"[dp] after {DP_STEPS} steps: {len(leaf_tol)} leaves, the nearest its tolerance "
          f"{worst_leaf} {final[worst_leaf] / top(worst_leaf):.3g} of its max (tolerance "
          f"{leaf_tol[worst_leaf]:.3g}; the swapped run "
          f"{final_spread[worst_leaf] / top(worst_leaf):.3g}); worst over its max of the rest "
          + ", ".join(f"{k} {final[k] / top(k):.3g}" for k in sorted(
              leaf_tol, key=lambda k: -final[k] / top(k))[:3])
          + f"; {len(apart)} leaves of the cancelled biases, their moments and running means, "
          f"worst {worst_near} {final[worst_near]:.3g} (tolerance {bound:.3g})")
    assert all(np.isfinite(got["losses"])) and loss_err <= TRAIN_LOSS_TOL, loss_err
    assert rel[worst] <= grad_tol and near <= 1e-5 * scale, (worst, rel[worst], near)
    assert stats_err <= TRAIN_STATS_TOL, stats_err
    assert over[worst_leaf] <= 1.0, (worst_leaf, final[worst_leaf], leaf_tol[worst_leaf])
    assert final[worst_near] <= bound, (worst_near, final[worst_near])
    return [r["launches"] for r in ranks]


def _train_cli_data(workdir: Path, device: str) -> tuple:
    """Phase 7's data: ``python -m se_tpu_torch.data.make_synth_corpus
    <workdir>/corpus 4 4 1`` in a subprocess, as a user builds a corpus (the
    noise and clean trees, ``generate_corpus``, ``pack_corpus``): 4 clean
    files at SNRs 0 and 5 dB, 8 training rows, and 4 validation rows, of 3 s
    -> (the train CLI's arguments for 2 epochs at TRAIN_CLI_BATCH on its
    ``train.npy`` and ``valid.npy``, the validation array).  A failed build
    fails the run."""
    corpus = workdir / "corpus"
    t0 = time.perf_counter()
    built = subprocess.run([sys.executable, "-m", "se_tpu_torch.data.make_synth_corpus",
                            str(corpus), "4", "4", "1"], cwd=REPO, capture_output=True, text=True)
    build_s = time.perf_counter() - t0
    assert built.returncode == 0, built.stderr[-3000:]
    train, valid = (np.load(corpus / f"{name}.npy") for name in ("train", "valid"))
    print(f"[train-cli] corpus from se_tpu_torch.data.make_synth_corpus in {build_s:.2f} s of "
          f"host time: train {train.shape} {train.dtype}, valid {valid.shape} {valid.dtype}")
    assert train.shape == (8, 2, 48000) and valid.shape == (4, 2, 48000), (train.shape, valid.shape)
    assert np.isfinite(train).all() and np.isfinite(valid).all()
    common = ["--train-data", str(corpus / "train.npy"), "--valid-data",
              str(corpus / "valid.npy"), "--batch", str(TRAIN_CLI_BATCH), "--max-epochs", "2",
              "--job-dir", str(workdir / "models"), "--logs-dir", str(workdir / "logs"),
              "--device", device]
    return common, valid


def _resume_copy(run: Path, suffix: str = "resumed") -> Path:
    """A copy of the run directory ``run`` as it stood after epoch 1."""
    copy = run.with_name(f"{run.name}_{suffix}")
    copy.mkdir()
    for name in ("log.txt", "chkpt_1.pt", "Epoch_1_SCORES"):
        (copy / name).write_bytes((run / name).read_bytes())
    mse = np.load(run / "mse_vali_total.npy")
    np.save(copy / "mse_vali_total.npy", np.array([mse[0], 0.0]))
    return copy


def _resume_readings(run: Path, copy: Path, param_names: list, lr: float, epoch: int = 2,
                     steps=(3, 4)) -> dict:
    """The run in ``copy`` against the ``run`` it should equal at ``epoch``
    (a resume of it at epoch 2): ``rel``, each leaf of ``chkpt_{epoch}.pt``
    (parameter or buffer, Adam's moments) but the BatchNorm-cancelled ones,
    its max |difference| over its max; ``near``, those, absolute, against
    ``bound``, Adam's over the ``steps`` in which the runs can part;
    ``loss``, the epoch's validation loss's relative difference; ``epoch``,
    the blob's."""
    got = torch.load(copy / f"chkpt_{epoch}.pt", map_location="cpu", weights_only=True)
    want = torch.load(run / f"chkpt_{epoch}.pt", map_location="cpu", weights_only=True)
    # leaves by the name of the parameter or buffer they belong to: Adam's
    # state is keyed by the parameter's index in model.parameters()
    cancelled = _cancelled_by_batch_norm(want["model"])
    apart = cancelled | {k.rsplit(".", 3)[0] + ".1.running_mean" for k in cancelled}
    leaves = {(k, "value"): (v, got["model"][k]) for k, v in want["model"].items()
              if v.is_floating_point()}
    for i, st in want["optimizer"]["state"].items():
        leaves.update({(param_names[i], k): (v, got["optimizer"]["state"][i][k])
                       for k, v in st.items() if torch.is_tensor(v)})
    mse, mse_resumed = np.load(run / "mse_vali_total.npy"), np.load(copy / "mse_vali_total.npy")
    e = epoch - 1
    return dict(
        rel={f"{k} {what}": _max_err(a, b) / max(a.abs().max().item(), 1e-30)
             for (k, what), (a, b) in leaves.items() if k not in apart},
        near={f"{k} {what}": _max_err(a, b) for (k, what), (a, b) in leaves.items()
              if k in apart},
        bound=2 * lr * sum(t**0.5 for t in steps), epoch=got["epoch"],
        loss=abs(mse_resumed[e] - mse[e]) / abs(mse[e]), losses=(mse_resumed[e], mse[e]))


def _resume_summary(r: dict) -> str:
    worst = sorted(r["rel"].items(), key=lambda kv: -kv[1])[:4]
    return (f"epoch {r['epoch']}; {len(r['rel'])} leaves, worst over the leaf's max "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst) + f" (tolerance {RESUME_LEAF_TOL}); "
            f"{len(r['near'])} leaves of the BatchNorm-cancelled biases (with their Adam "
            f"moments) and their running means, worst {max(r['near'].values()):.3g} "
            f"(tolerance {r['bound']:.3g}); epoch-{r['epoch']} validation loss {r['losses'][0]} "
            f"against "
            f"{r['losses'][1]}: relative {r['loss']:.3g} (tolerance {RESUME_LOSS_TOL})")


def phase_train_cli(workdir: Path, device="cuda") -> None:
    """The train CLI on the card for the default ``Config`` at full width:
    ``_train_cli_data``'s corpus, ``--batch 4 --max-epochs 2``, real
    PESQ (the native P.862.2) and STOI.  (1) ``train_interface.main`` in this
    process, every count set to 0 just before and read just after: K1f 2 x (4
    train steps + 2 validation batches), K1b 2 x 4, nothing else; the run's
    artifacts and scores.  (2) A resume of a copy of the run directory as it
    stood after epoch 1, in a subprocess, held to the uninterrupted run's
    epoch 2.  (3) ``Epoch_1_SCORES`` against ``eval_step`` on ``chkpt_1.pt``
    in a fresh model, scored by ``cal_pesq``/``cal_stoi``.  (4) Meanwhile the
    CLI with ``--mesh`` for 1 epoch under ``torch.distributed.run
    --nproc_per_node=1`` (NCCL on the card), its run directory, and its
    epoch-1 losses and ``chkpt_1.pt`` held to (1)'s: both start from the
    seed's weights on the same batches, and part by the BatchNorms' and the
    reductions' order only.  Every number is printed before any is
    checked."""
    from se_tpu_torch import train_interface
    from se_tpu_torch.config import Config
    from se_tpu_torch.eval.metrics import cal_pesq, cal_stoi
    from se_tpu_torch.train.loop import score_workers
    from se_tpu_torch.train.state import create_train_state
    from se_tpu_torch.train.steps import eval_step

    t0 = time.perf_counter()
    cfg = Config()
    fs, batch = cfg.stft.fs, TRAIN_CLI_BATCH
    common, valid = _train_cli_data(workdir, device)

    # (1) the uninterrupted run
    _zero_counts()
    trainer = train_interface.main(common)
    torch.cuda.synchronize()
    launches = _counts()
    run = Path(trainer.dir_to_save)
    hist = trainer.history
    steps = sum(h["steps"] for h in hist)
    expected = _expected({"K1f": cfg.dccrn.rnn_layers}, steps + 2)
    expected["K1b"] = cfg.dccrn.rnn_layers * steps
    print(f"[train-cli] 2 epochs of {steps // 2} steps at B={batch} and 1 validation batch: "
          f"launches {launches}")
    print("[train-cli] epochs: " + "; ".join(
        f"{h['epoch']}: train loss {h['train_loss']}, validation loss {h['valid_loss']}, "
        f"PESQ {h['pesq']}, STOI {h['stoi']}" for h in hist))
    scores = {e: np.array([[float(v) for v in line.replace("PESQ", "").split("| STOI")]
                           for line in (run / f"Epoch_{e}_SCORES").read_text().splitlines()])
              for e in (1, 2)}

    # (2) the resume, from a copy of the run directory as it stood after epoch 1
    copy = _resume_copy(run)
    proc = subprocess.Popen([sys.executable, "-m", "se_tpu_torch.train_interface", *common,
                             "--chkpt-model", copy.name, "--chkpt", "1"],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # (4) the --mesh run, one rank under torchrun
    t_mesh = time.perf_counter()
    mesh_args = [*common, "--max-epochs", "1", "--job-dir", str(workdir / "mesh" / "models"),
                 "--logs-dir", str(workdir / "mesh" / "logs"), "--mesh"]
    mesh_proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                  "--nproc_per_node=1", "-m", "se_tpu_torch.train_interface",
                                  *mesh_args], cwd=REPO, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
    try:
        # (3) meanwhile, epoch 1's scores again from chkpt_1.pt
        t_score = time.perf_counter()
        blob = torch.load(run / "chkpt_1.pt", map_location="cpu", weights_only=True)
        model, _ = create_train_state(cfg, blob["model"], device=device)
        ests = [eval_step(cfg, model, valid[i : i + batch, 0], valid[i : i + batch, 1])[1]
                .float().cpu().numpy() for i in range(0, len(valid), batch)]
        est = np.concatenate(ests)
        workers = score_workers(batch)
        again = np.stack([cal_pesq(est, valid[:, 1], fs, workers=workers),
                          cal_stoi(est, valid[:, 1], fs, workers=workers)], 1)
        rescore_s = time.perf_counter() - t_score
        stdout, stderr = proc.communicate(timeout=600)
        mesh_out, mesh_err = mesh_proc.communicate(timeout=600)
        mesh_s = time.perf_counter() - t_mesh
    finally:
        for p in (proc, mesh_proc):
            if p.poll() is None:
                p.kill()
                p.wait()
    print(stdout.strip().splitlines()[-3:])
    assert proc.returncode == 0, stderr[-3000:]
    print(f"[train-cli] --mesh under torch.distributed.run, 1 epoch in {mesh_s:.1f} s: "
          + "; ".join(line for line in mesh_out.splitlines()
                      if line.startswith(("mesh:", "Epoch"))))
    assert mesh_proc.returncode == 0, (mesh_out[-2000:], mesh_err[-3000:])
    r = _resume_readings(run, copy, [k for k, _ in model.named_parameters()],
                         cfg.train.learning_rate)
    print(f"[train-cli] resume, chkpt_2.pt against the uninterrupted run's: {_resume_summary(r)}")
    (mesh_run,) = (workdir / "mesh" / "models").iterdir()
    names = [k for k, _ in model.named_parameters()]
    rm = _resume_readings(run, mesh_run, names, cfg.train.learning_rate, epoch=1,
                          steps=range(1, steps // 2 + 1))
    # From the same weights each step moves a parameter by at most Adam's
    # bound, so a value that roundoff flips Adam's sign on parts by up to it
    # (1.7% of a leaf's max, enhance.1.r_trans.weight, on an H100): the
    # values are held to the bound, the losses tightly
    mesh_blob, one_blob = (torch.load(d / "chkpt_1.pt", map_location="cpu", weights_only=True)
                           for d in (mesh_run, run))
    value_err = max(_max_err(mesh_blob["model"][k], one_blob["model"][k]) for k in names)
    mesh_train = float((mesh_run / "log.txt").read_text().split("| T ")[1].split()[0])
    train_err = abs(mesh_train - hist[0]["train_loss"]) / max(1.0, abs(hist[0]["train_loss"]))
    print(f"[train-cli] --mesh run's chkpt_1.pt against the one-process run's: "
          f"{_resume_summary(rm)}; parameters max |diff| {value_err:.3g} (tolerance "
          f"{rm['bound']:.3g}); epoch-1 train loss {mesh_train} against "
          f"{hist[0]['train_loss']}: relative {train_err:.3g} (tolerance {TRAIN_LOSS_TOL})")
    mesh_scores = (mesh_run / "Epoch_1_SCORES").read_text().splitlines()
    score_err = np.abs(again - scores[1]).max()
    print(f"[train-cli] Epoch_1_SCORES against chkpt_1.pt rescored in process: max |diff| "
          f"{score_err:.3g} (tolerance {SCORES_TOL}); {again.tolist()}")
    wall = time.perf_counter() - t0
    train_s = sum(h["train_seconds"] for h in hist)
    per_epoch = ", ".join(f"epoch {h['epoch']} {1e3 * h['train_seconds'] / h['steps']:.3f}"
                          for h in hist)
    score_s = " + ".join(f"{h['score_seconds']:.2f}" for h in hist)
    print(f"[train-cli] phase {wall:.1f} s; training {1e3 * train_s / steps:.3f} ms per step "
          f"over {steps} steps ({per_epoch}; epoch wall time over its steps, the first with "
          f"cuDNN's warm-up); scoring (native P.862.2 and STOI) {score_s} s in the 2 epochs; "
          f"rescoring with the checkpoint's forward {rescore_s:.2f} s")

    assert launches == expected, (launches, expected)
    assert all(np.isfinite([h["train_loss"], h["valid_loss"]]).all() for h in hist), hist
    assert {"log.txt", "chkpt_1.pt", "chkpt_2.pt", "chkpt_opt.pt", "mse_vali_total.npy",
            "Epoch_1_SCORES", "Epoch_2_SCORES"} <= {p.name for p in run.iterdir()}
    for e, sc in scores.items():
        assert sc.shape == (len(valid), 2), (e, sc)
        assert np.isfinite(sc).all() and (sc[:, 0] >= 1.0).all() and (sc[:, 0] <= 4.64).all(), sc
        assert (sc[:, 1] >= 0.0).all() and (sc[:, 1] <= 1.0).all(), sc
    assert r["epoch"] == 2 and r["rel"] and r["near"]
    assert max(r["rel"].values()) <= RESUME_LEAF_TOL and max(r["near"].values()) <= r["bound"]
    assert r["loss"] <= RESUME_LOSS_TOL, r["loss"]
    assert score_err <= SCORES_TOL, score_err
    backend = "nccl" if device == "cuda" else "gloo"
    where = "cuda:0" if device == "cuda" else "cpu"
    assert f"mesh: rank 0 of 1 on {where}, torch.distributed group ({backend})" in mesh_out
    assert {"log.txt", "chkpt_1.pt", "chkpt_opt.pt", "mse_vali_total.npy",
            "Epoch_1_SCORES"} <= {p.name for p in mesh_run.iterdir()}
    assert len(mesh_scores) == len(valid), mesh_scores
    assert rm["epoch"] == 1 and value_err <= rm["bound"] and train_err <= TRAIN_LOSS_TOL
    assert max(rm["near"].values()) <= rm["bound"] and rm["loss"] <= RESUME_LOSS_TOL, rm


def main() -> int:
    t0 = time.perf_counter()

    def stamp(what):
        print(f"[time] {what} done at {time.perf_counter() - t0:.1f} s", flush=True)

    smi = phase_environment()
    phase_build()
    fwd = phase_lstm_kernel()
    bwd, stash_times = phase_lstm_backward()
    k2f, k2b = phase_inproj_kernels()
    stamp("K1, K2")
    k1f16, k1b16, k2f16, k2b16 = phase_bf16_kernels()
    stamp("K1, K2 bf16")
    k2f_cs16, k2b_cs16 = phase_stash_kernels()
    stamp("K2 with the bf16 stash")
    k3f, k3b = phase_gru_kernels()
    k4 = phase_conv_kernel()
    stamp("K3, K4")
    k3f16, k3b16 = phase_gru_kernels(torch.bfloat16)
    k4_16 = phase_conv_kernel(torch.bfloat16)
    stamp("K3, K4 bf16")
    stream_kernels = phase_stream_kernels()
    stamp("K1f, K2f, K3f, K4 at the streaming shapes")
    p1, p2, p3 = phase_probes()
    stamp("probes")
    paths = _paths()
    enhanced, waves = {}, {}
    for label, (cfg, sd, per_fwd, _, _) in paths.items():
        if label in TRAIN_ONLY:
            continue
        enhanced[label], waves[label] = phase_slice(label, cfg, sd, per_fwd)
        stamp(f"slice {label}")
    err = _max_err(waves["DCCRN-fused-conv"], waves["DCCRN"])
    print(f"[slice DCCRN-fused-conv] max |K4 encoder - cuDNN block-form encoder| wav {err} "
          f"(tolerance {SLICE_TOL})")
    assert err <= SLICE_TOL, err
    for label in ("DCCRN", "CRN", "DCCRN-real", "FullSubNet", "FullSubNet-GRU",
                  "DCCRN-fused-conv"):
        diff = (waves[f"{label}-bf16"] - waves[label]).abs()
        print(f"[slice {label}-bf16] |bf16 - f32| wav on the card, same weights and input: mean "
              f"{diff.mean().item()} (tolerance {BF16_VS_F32_MEAN}), max {diff.max().item()}")
        assert diff.mean().item() < BF16_VS_F32_MEAN, diff.mean().item()
    # both bf16, the encoder's conv rounded once (K4) against twice (cuDNN's
    # conv, then the bias add), so held as the card to the CPU in bf16
    diff = (waves["DCCRN-fused-conv-bf16"] - waves["DCCRN-bf16"]).abs()
    print(f"[slice DCCRN-fused-conv-bf16] |K4 encoder - cuDNN encoder| wav, both bf16: max "
          f"{diff.max().item()} (tolerance {BF16_SLICE_TOL}), mean {diff.mean().item()} "
          f"(tolerance {BF16_SLICE_MEAN_TOL})")
    assert diff.max().item() <= BF16_SLICE_TOL and diff.mean().item() <= BF16_SLICE_MEAN_TOL
    streams = _stream_paths(paths)
    streamed = {label: phase_stream(label, *args) for label, args in streams.items()}
    # the fused conv's stream against the default DCCRN's, as phase 4 holds
    # their batch waveforms
    err = _max_err(streamed["DCCRN-fused-conv"]["wav"], streamed["DCCRN"]["wav"])
    print(f"[stream DCCRN-fused-conv] max |K4 encoder - cuDNN block-form encoder| streamed wav "
          f"{err} (tolerance {SLICE_TOL})")
    assert err <= SLICE_TOL, err
    stamp("streaming")
    trained = {}
    # Main-path depths, set to keep the script within its time: 5 steps for
    # DCCRN, CRN and DCCRN-PMSQE, the trainer variants' main path; 3 for
    # DCCRN-fused-conv and the bf16 DCCRNs and CRN (their losses fall from
    # the second step); 10 for the FullSubNets, whose falling-loss check
    # needs them
    for label, steps in (("DCCRN", 5), ("CRN", 5), ("DCCRN-real", 0), ("FullSubNet", 10),
                         ("FullSubNet-GRU", 10), ("DCCRN-fused-conv", 3), ("DCCRN-bf16", 3),
                         ("CRN-bf16", 3), ("DCCRN-real-bf16", 3), ("FullSubNet-bf16", 10),
                         ("FullSubNet-GRU-bf16", 10), ("DCCRN-fused-conv-bf16", 3),
                         ("DCCRN-PMSQE", 5), ("DCCRN-LMS-bf16", 0), ("DCCRN-direct", 0),
                         ("DCCRN-cbn-noskip", 0), ("CRN-noskip-LMS", 0)):
        cfg, sd, per_fwd, per_bwd, _ = paths[label]
        trained[label] = phase_train(label, cfg, sd, per_fwd, per_bwd, steps)
        stamp(f"train {label}")
    # DCCRN-bf16's main path once more with Adam's first moment in bf16
    cfg, sd, per_fwd, per_bwd, _ = paths["DCCRN-bf16"]
    mu_cfg = cfg.replace(train=dataclasses.replace(cfg.train, adam_mu_dtype="bfloat16"))
    trained["DCCRN-bf16-adam-mu"] = (None, _train_steps("DCCRN-bf16 adam_mu_dtype=bfloat16",
                                                        mu_cfg, sd, {**per_fwd, **per_bwd},
                                                        steps=3))
    cfg, sd, per_fwd, per_bwd, _ = paths["CRN"]
    trained["CRN-direct"] = phase_train(
        "CRN-direct", cfg.replace(masking_mode="Direct(None make)"), sd, per_fwd, per_bwd,
        steps=0)
    stamp("train")
    stash_launches = phase_stash_train(paths)
    stamp("train CRN with the bf16 stash")
    remat = phase_remat(paths)
    stamp("remat_convs")
    phase_fsn_init_and_norms()
    stamp("FullSubNet weight_init and the EMA norms")
    build_dir = REPO / "build"
    build_dir.mkdir(exist_ok=True)
    # the data-parallel ranks (phase 6b) start now, after every timed phase,
    # and train while phase 6's processes run
    dccrn_cfg, dccrn_sd, _, _, _ = paths["DCCRN"]
    dp = phase_dp_start(dccrn_cfg, dccrn_sd)
    # the train CLI's scoring workers (phase 7; Trainer.setup finds them
    # running) start now too: each spawned interpreter imports this script,
    # torch with it, and scipy while phase 6 runs
    from se_tpu_torch.eval.metrics import start_pool
    from se_tpu_torch.train.loop import score_workers

    start_pool(score_workers(TRAIN_CLI_BATCH))
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        # the streaming CLI once per family, the fused conv's path aside (no
        # CLI takes that switch)
        phase_cli(Path(tmp), paths, held_to={"DCCRN-cbn-noskip": waves["DCCRN-cbn-noskip"]},
                  streams={k: streams[k][:2] for k in ("DCCRN", "CRN", "FullSubNet")})
    stamp("CLI")
    dp_launches = phase_dp_check(dp, dccrn_cfg, dccrn_sd,
                                 {**paths["DCCRN"][2], **paths["DCCRN"][3]})
    stamp("data-parallel")
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        phase_train_cli(Path(tmp))
    stamp("train CLI")

    k2_paths = ("CRN", "DCCRN-real", "FullSubNet")
    k2_train = (*k2_paths, "CRN-direct", "CRN-noskip-LMS")
    k1_paths = ("DCCRN", "DCCRN-fused-conv", "DCCRN-cbn-noskip")
    k1_train = (*k1_paths, "DCCRN-PMSQE", "DCCRN-direct")
    fwd.update(launches=enhanced["DCCRN"]["K1f"],
               launches_per_forward={k: enhanced[k]["K1f"] for k in k1_paths},
               launches_per_train_step={k: trained[k][0]["K1f"] for k in k1_train},
               launches_in_5_steps_pmsqe=trained["DCCRN-PMSQE"][1]["K1f"],
               launches_per_rank_in_3_data_parallel_steps=[r["K1f"] for r in dp_launches],
               **stash_times)
    bwd.update(launches=trained["DCCRN"][1]["K1b"],
               launches_per_train_step={k: trained[k][0]["K1b"] for k in k1_train},
               launches_in_5_steps_pmsqe=trained["DCCRN-PMSQE"][1]["K1b"],
               launches_per_rank_in_3_data_parallel_steps=[r["K1b"] for r in dp_launches])
    k2f.update(launches=enhanced["CRN"]["K2f"],
               launches_per_forward={k: enhanced[k]["K2f"] for k in k2_paths},
               launches_per_train_step={k: trained[k][0]["K2f"] for k in k2_train})
    k2b.update(launches=trained["CRN"][1]["K2b"],
               launches_per_train_step={k: trained[k][0]["K2b"] for k in k2_train})
    k3f.update(launches=enhanced["FullSubNet-GRU"]["K3f"],
               launches_per_forward=enhanced["FullSubNet-GRU"]["K3f"],
               launches_per_train_step=trained["FullSubNet-GRU"][0]["K3f"])
    k3b.update(launches=trained["FullSubNet-GRU"][1]["K3b"],
               launches_per_train_step=trained["FullSubNet-GRU"][0]["K3b"])
    k4.update(launches=enhanced["DCCRN-fused-conv"]["K4"],
              launches_per_forward=enhanced["DCCRN-fused-conv"]["K4"],
              launches_per_train_step=trained["DCCRN-fused-conv"][0]["K4"],
              launches_in_3_train_steps=trained["DCCRN-fused-conv"][1]["K4"])
    k1_16 = ("DCCRN-bf16", "DCCRN-fused-conv-bf16")
    k1f16.update(launches=enhanced["DCCRN-bf16"]["K1f-bf16"],
                 launches_per_forward={k: enhanced[k]["K1f-bf16"] for k in k1_16},
                 launches_per_train_step={k: trained[k][0]["K1f-bf16"]
                                          for k in (*k1_16, "DCCRN-LMS-bf16")})
    k1b16.update(launches=trained["DCCRN-bf16"][1]["K1b-bf16"],
                 launches_per_train_step={k: trained[k][0]["K1b-bf16"]
                                          for k in (*k1_16, "DCCRN-LMS-bf16")},
                 launches_in_3_steps_adam_mu_bf16=trained["DCCRN-bf16-adam-mu"][1]["K1b-bf16"])
    k2_16 = ("CRN-bf16", "FullSubNet-bf16")
    k2f16.update(launches=enhanced["CRN-bf16"]["K2f-bf16"],
                 launches_per_forward={k: enhanced[k]["K2f-bf16"] for k in k2_16},
                 launches_per_train_step={k: trained[k][0]["K2f-bf16"] for k in k2_16})
    k2b16.update(launches=trained["CRN-bf16"][1]["K2b-bf16"],
                 launches_per_train_step={k: trained[k][0]["K2b-bf16"] for k in k2_16},
                 launches_in_10_steps_fullsubnet=trained["FullSubNet-bf16"][1]["K2b-bf16"])
    k3f16.update(launches=enhanced["FullSubNet-GRU-bf16"]["K3f-bf16"],
                 launches_per_forward=enhanced["FullSubNet-GRU-bf16"]["K3f-bf16"],
                 launches_per_train_step=trained["FullSubNet-GRU-bf16"][0]["K3f-bf16"])
    k3b16.update(launches=trained["FullSubNet-GRU-bf16"][1]["K3b-bf16"],
                 launches_per_train_step=trained["FullSubNet-GRU-bf16"][0]["K3b-bf16"])
    k4_16.update(launches=enhanced["DCCRN-fused-conv-bf16"]["K4-bf16"],
                 launches_per_forward=enhanced["DCCRN-fused-conv-bf16"]["K4-bf16"],
                 launches_per_train_step=trained["DCCRN-fused-conv-bf16"][0]["K4-bf16"],
                 launches_in_3_train_steps=trained["DCCRN-fused-conv-bf16"][1]["K4-bf16"])
    k4.update(launches_per_remat_train_step=remat["DCCRN-fused-conv"]["launches"]["K4"])
    fwd.update(launches_per_remat_train_step={k: r["launches"]["K1f"] for k, r in remat.items()})
    bwd.update(launches_per_remat_train_step={k: r["launches"]["K1b"] for k, r in remat.items()})
    k2f_cs16.update(launches=stash_launches["K2f-cs16"],
                    launches_per_train_step={"CRN": stash_launches["K2f-cs16"]})
    k2b_cs16.update(launches=stash_launches["K2b-cs16"],
                    launches_per_train_step={"CRN": stash_launches["K2b-cs16"]})
    for key, labels in (("K1f", ("DCCRN", "DCCRN-fused-conv")),
                        ("K2f", ("CRN", "DCCRN-real", "FullSubNet")),
                        ("K3f", ("FullSubNet-GRU",)), ("K4", ("DCCRN-fused-conv",))):
        entry = {"K1f": fwd, "K2f": k2f, "K3f": k3f, "K4": k4}[key]
        entry.update(stream_max_abs_err=stream_kernels[key]["max_abs_err"],
                     stream_shapes=stream_kernels[key]["shapes"],
                     stream_launches={k: streamed[k]["launches"][key] for k in labels},
                     stream_launches_per_chunk={k: streamed[k]["launches_per_chunk"][key]
                                                for k in labels})
    stamp("every check")
    print(smi)
    print(json.dumps({"kernels": [fwd, bwd, k2f, k2b, k3f, k3b, k4, p1, p2, p3,
                                  k1f16, k1b16, k2f16, k2b16, k3f16, k3b16, k4_16,
                                  k2f_cs16, k2b_cs16]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
