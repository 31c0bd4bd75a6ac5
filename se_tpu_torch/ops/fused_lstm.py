"""Fused LSTM-stack scan: the hand-written CUDA kernels
``csrc/lstm_scan.cu`` (forward and backward) and their plain PyTorch
versions.

Counterpart of ``fused_lstm_scan`` in ``se_tpu/ops/pallas_lstm.py``.  As
there, the plain call (inference) writes no cell-state stash; when an input
needs a gradient, the call goes through a ``torch.autograd.Function`` whose
forward also writes the stash ``cs`` and whose backward recomputes the
gates from ``(x_proj, h_prev)``.  The kernels' design and what bounds them
are described at the top of their source; :func:`plan` picks the tiling
of each launch.

Two forms, as the Pallas kernel has: f32, and the bf16-stream form, in
which ``x_proj``, ``ys``, their cotangent ``dys`` and the gradient
``dx_proj`` are bf16 while the carry, the gate math, the stash and the
weight gradients stay f32 (``pallas_lstm.py:13-14``).  The plain versions
take the form from ``x_proj``'s dtype; each kernel form has its own C entry
and its own launch count (``launches``, ``launches_bf16``).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .cluster_plan import ROW_QUANTUM, Plan
from .cluster_plan import plan as _cluster_plan

# K1's tilings, measured at DCCRN's shapes (T=483, L=2, H=128) on an H100
# (PERF.md §6, ``kernels_ab.py``: every N in 2, 4, 8, 16 against every R in
# 4, 8, 16, 20): the forward fastest on clusters of 8 CTAs, the backward on
# 16, each in tiles of as few rows as keep every cluster of the launch on
# the card at once; a launch of more clusters than fit runs in waves, each
# a whole chain of T steps (16 CTAs in tiles of 4 rows: 3.77 ms forward
# against 1.94 in tiles of 8).
CTAS = {False: 8, True: 16}  # by backward
# clusters of 8 and of 16 CTAs of these kernels that an H100 holds at once
# (the occupancy query at DCCRN's tilings, PERF.md §6)
CLUSTERS_AT_ONCE = {8: 15, 16: 7}


def plan(L: int, Bb: int, H: int, backward: bool = False) -> Plan:
    """The tiling of a K1 launch (forward, or the backward's reverse scan)
    of ``L`` stacks over ``Bb`` rows of ``H`` units: K2's LSTM cluster
    kernels without the input projection (:func:`cluster_plan.plan` at
    ``In = 0``) on ``CTAS[backward]`` CTAs, in tiles of as few rows as keep
    the launch's ``L`` x tiles clusters within ``CLUSTERS_AT_ONCE``."""
    N = CTAS[backward]
    tiles = max(1, CLUSTERS_AT_ONCE[N] // L)
    rows = ROW_QUANTUM * -(-Bb // (ROW_QUANTUM * tiles))
    return _cluster_plan(Bb, 0, H, backward, max_rows=rows, N=N)


def active_clusters(L: int, Bb: int, H: int, backward: bool = False, device=None) -> int:
    """How many clusters of :func:`plan`'s tiling fit on the CUDA ``device``
    at once (the runtime's occupancy query; 0: none, and a launch raises)."""
    p = plan(L, Bb, H, backward)
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _library()
    n = lib.se_lstm_scan_active_clusters(int(backward), H, p.R, p.N, p.C, int(p.resident), index)
    if n < 0:
        msg = lib.se_cuda_error_string(-n).decode()
        raise RuntimeError(f"K1 occupancy query failed: CUDA error {-n} ({msg})")
    return n


def _reference_forward(x_proj, w_hh_t, h0, c0, need_cs):
    """The plain recurrence -> ``(ys, cs or None, hT, cT)``."""
    H = h0.shape[-1]
    h, c = h0.float(), c0.float()
    w = w_hh_t.float()
    ys, cs = [], []
    for t in range(x_proj.shape[0]):
        gates = x_proj[t].float() + torch.bmm(h, w)
        i = torch.sigmoid(gates[..., 0 * H : 1 * H])
        f = torch.sigmoid(gates[..., 1 * H : 2 * H])
        g = torch.tanh(gates[..., 2 * H : 3 * H])
        o = torch.sigmoid(gates[..., 3 * H : 4 * H])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h.to(x_proj.dtype))
        if need_cs:
            cs.append(c)
    return torch.stack(ys), torch.stack(cs) if need_cs else None, h, c


def fused_lstm_scan_reference(x_proj, w_hh_t, h0, c0):
    """The plain recurrence: ``x_proj [T, L, Bb, 4H]`` (biases folded in),
    ``w_hh_t [L, H, 4H]``, ``h0``/``c0 [L, Bb, H]`` ->
    ``(ys [T, L, Bb, H] in x_proj's dtype, (hT, cT) f32)``.

    Gate order i, f, g, o; the carry and the gate math are f32.
    """
    ys, _, hT, cT = _reference_forward(x_proj, w_hh_t, h0, c0, need_cs=False)
    return ys, (hT, cT)


def fused_lstm_scan_backward_reference(x_proj, w_hh_t, h0, c0, ys, cs, dys, dhT, dcT):
    """The plain backward, step by step as the Pallas ``_bwd_kernel``:
    the forward's inputs, its ``ys`` and stash ``cs [T, L, Bb, H]``, and
    the cotangents of ``(ys, hT, cT)`` -> ``(dx_proj, dw_hh_t, dh0, dc0)``."""
    T = x_proj.shape[0]
    H = h0.shape[-1]
    w = w_hh_t.float()
    dh, dc = dhT.float(), dcT.float()
    dw = torch.zeros_like(w)
    dxp = []
    for t in range(T - 1, -1, -1):
        h_prev = h0 if t == 0 else ys[t - 1].float()
        c_prev = c0 if t == 0 else cs[t - 1]
        gates = x_proj[t].float() + torch.bmm(h_prev, w)
        i = torch.sigmoid(gates[..., 0 * H : 1 * H])
        f = torch.sigmoid(gates[..., 1 * H : 2 * H])
        g = torch.tanh(gates[..., 2 * H : 3 * H])
        o = torch.sigmoid(gates[..., 3 * H : 4 * H])
        tanh_c = torch.tanh(cs[t])
        dh = dys[t].float() + dh
        do = dh * tanh_c * o * (1.0 - o)
        dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
        di = dc * g * i * (1.0 - i)
        df = dc * c_prev * f * (1.0 - f)
        dg = dc * i * (1.0 - g * g)
        dgates = torch.cat([di, df, dg, do], dim=-1)  # [L, Bb, 4H]
        dxp.append(dgates.to(x_proj.dtype))
        dw = dw + torch.bmm(h_prev.transpose(1, 2), dgates)
        dh = torch.bmm(dgates, w.transpose(1, 2))
        dc = dc * f
    return torch.stack(dxp[::-1]), dw, dh, dc


def _check(x_proj, w_hh_t, h0, c0):
    """Shapes, devices and dtypes: x_proj float32 or bfloat16, the rest
    float32."""
    if x_proj.ndim != 4:
        raise ValueError(f"x_proj must be [T, L, Bb, 4H], got {tuple(x_proj.shape)}")
    T, L, Bb, G = x_proj.shape
    if G % 4:
        raise ValueError(f"x_proj's last axis must be 4H, got {G}")
    H = G // 4
    want = {"w_hh_t": (L, H, G), "h0": (L, Bb, H), "c0": (L, Bb, H)}
    for name, t in (("w_hh_t", w_hh_t), ("h0", h0), ("c0", c0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    build.check_dtypes((("x_proj", x_proj, True), ("w_hh_t", w_hh_t, False),
                        ("h0", h0, False), ("c0", c0, False)), x_proj.dtype)
    for name, t in (("w_hh_t", w_hh_t), ("h0", h0), ("c0", c0)):
        if t.device != x_proj.device:
            raise ValueError(f"{name} is on {t.device}, x_proj on {x_proj.device}")


def _library():
    """The built kernel library, with its C signatures declared."""
    lib = build.load("lstm_scan")
    if lib.se_lstm_scan_fwd_f32.argtypes is None:
        for form in build.STREAM_FORMS.values():
            fwd = getattr(lib, f"se_lstm_scan_fwd_{form}")
            bwd = getattr(lib, f"se_lstm_scan_bwd_{form}")
            # dims (T, L, Bb, H), the tiling (R, N, C, resident), device
            fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
            # the bf16 form takes the f32 dgates scratch after dc0; both
            # the reductions' workspace last, and its size after the tiling
            n_ptr = 15 if form == "f32" else 16
            bwd.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 10 + [ctypes.c_void_p]
            fwd.restype = bwd.restype = ctypes.c_int
        lib.se_lstm_scan_active_clusters.argtypes = [ctypes.c_int] * 7
        lib.se_lstm_scan_active_clusters.restype = ctypes.c_int
    return lib


def _forward(x_proj, w_hh_t, h0, c0, need_cs):
    """``(ys, cs or None, hT, cT)``: the plain version for CPU tensors, the
    forward kernel for CUDA tensors (counted on ``fused_lstm_scan``)."""
    dev = x_proj.device
    if dev.type == "cpu":
        return _reference_forward(x_proj, w_hh_t, h0, c0, need_cs)
    T, L, Bb, G = x_proj.shape
    H = G // 4
    sdt, f32 = x_proj.dtype, torch.float32
    new = lambda *shape: torch.empty(shape, device=dev, dtype=f32)
    ys = torch.empty((T, L, Bb, H), device=dev, dtype=sdt)
    hT, cT = new(L, Bb, H), new(L, Bb, H)
    cs = new(T, L, Bb, H) if need_cs else None
    build.cuda_launch(
        _library(), f"se_lstm_scan_fwd_{build.STREAM_FORMS[sdt]}", (x_proj, w_hh_t, h0, c0),
        ("x_proj", "w_hh_t", "h0", "c0"), (ys, cs, hT, cT),
        (T, L, Bb, H, *plan(L, Bb, H).args()), dev, (sdt, f32, f32, f32),
    )
    build.count_launch(fused_lstm_scan, sdt)
    return ys, cs, hT, cT


def fused_lstm_scan_backward(x_proj, w_hh_t, h0, c0, ys, cs, dys, dhT, dcT):
    """Same signature and result as
    :func:`fused_lstm_scan_backward_reference`.

    CPU tensors run the plain version.  CUDA tensors launch the backward
    kernels (the reverse scan on :func:`plan`'s tiling, then the dW_hh
    reduction) on the current stream, or raise: contiguous only; x_proj, ys and dys all float32 or
    all bfloat16 (then dx_proj is bfloat16 too), the rest float32.  Each
    launch adds one to ``fused_lstm_scan_backward.launches`` (f32) or
    ``.launches_bf16``.
    """
    _check(x_proj, w_hh_t, h0, c0)
    T, L, Bb, G = x_proj.shape
    H = G // 4
    named = (("ys", ys, (T, L, Bb, H), True), ("cs", cs, (T, L, Bb, H), False),
             ("dys", dys, (T, L, Bb, H), True), ("dhT", dhT, (L, Bb, H), False),
             ("dcT", dcT, (L, Bb, H), False))
    for name, t, shape, _ in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    sdt = x_proj.dtype
    build.check_dtypes([(n, t, s) for n, t, _, s in named], sdt)
    dev = x_proj.device
    if dev.type == "cpu":
        return fused_lstm_scan_backward_reference(
            x_proj, w_hh_t, h0, c0, ys, cs, dys, dhT, dcT
        )
    f32 = torch.float32
    new = lambda *shape: torch.empty(shape, device=dev, dtype=f32)
    dxp = torch.empty((T, L, Bb, G), device=dev, dtype=sdt)
    dw, dh0, dc0 = new(L, H, G), new(L, Bb, H), new(L, Bb, H)
    # the bf16 form sums dW_hh from f32 dgates kept in a scratch buffer
    outs = (dxp, dw, dh0, dc0) + ((new(T, L, Bb, G),) if sdt == torch.bfloat16 else ())
    p = plan(L, Bb, H, backward=True)
    # a streamed slice reads W_hh along k: its transpose [L, 4H, H]
    w_hh = w_hh_t if p.resident else w_hh_t.transpose(1, 2).contiguous()
    build.cuda_launch(
        _library(), f"se_lstm_scan_bwd_{build.STREAM_FORMS[sdt]}",
        (x_proj, w_hh_t, w_hh, h0, c0, ys, cs, dys, dhT, dcT),
        ("x_proj", "w_hh_t", "w_hh", "h0", "c0", "ys", "cs", "dys", "dhT", "dcT"),
        (*outs, build.dw_workspace(dev)),
        (T, L, Bb, H, *p.args(), build.DW_WORKSPACE_FLOATS), dev,
        (sdt, f32, f32, f32, f32, sdt, f32, sdt, f32, f32),
    )
    build.count_launch(fused_lstm_scan_backward, sdt)
    return dxp, dw, dh0, dc0


class _FusedLstmScan(torch.autograd.Function):
    """The custom VJP of ``pallas_lstm.fused_lstm_scan``: the forward keeps
    ``(x_proj, w_hh_t, h0, c0, ys, cs)``; the backward maps ``(dys, dhT,
    dcT)``, zeros where an output was unused, to the four input gradients."""

    @staticmethod
    def forward(ctx, x_proj, w_hh_t, h0, c0):
        ys, cs, hT, cT = _forward(x_proj, w_hh_t, h0, c0, need_cs=True)
        ctx.save_for_backward(x_proj, w_hh_t, h0, c0, ys, cs)
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        saved = ctx.saved_tensors
        return fused_lstm_scan_backward(
            *saved, dys.contiguous(), dhT.contiguous(), dcT.contiguous()
        )


def fused_lstm_scan(x_proj, w_hh_t, h0, c0):
    """Same signature and result as :func:`fused_lstm_scan_reference`.

    CPU tensors run the plain version.  CUDA tensors launch the kernel on
    the current stream, or raise: contiguous only, x_proj float32 or
    bfloat16 (the bf16-stream form: ys bfloat16), the rest float32.  Each
    launch adds one to ``fused_lstm_scan.launches`` (f32) or
    ``.launches_bf16``.  When gradients are on and an
    input requires one, the call also writes the cell-state stash and its
    backward is :func:`fused_lstm_scan_backward`; otherwise no stash is
    allocated.
    """
    _check(x_proj, w_hh_t, h0, c0)
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x_proj, w_hh_t, h0, c0)
    ):
        ys, hT, cT = _FusedLstmScan.apply(x_proj, w_hh_t, h0, c0)
        return ys, (hT, cT)
    ys, _, hT, cT = _forward(x_proj, w_hh_t, h0, c0, need_cs=False)
    return ys, (hT, cT)


fused_lstm_scan.launches = fused_lstm_scan.launches_bf16 = 0
fused_lstm_scan_backward.launches = fused_lstm_scan_backward.launches_bf16 = 0
