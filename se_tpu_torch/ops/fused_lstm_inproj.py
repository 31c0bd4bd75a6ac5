"""Fused LSTM scan with the input projection inside the kernel: the
hand-written CUDA kernels ``csrc/lstm_inproj.cu`` (forward and backward)
and their plain PyTorch versions.

Counterpart of ``fused_lstm_scan_inproj`` in ``se_tpu/ops/pallas_lstm.py``.
Each step forms ``gates = x[t] @ w_ih_t + h @ w_hh_t + bias`` itself, so
the ``[T, Bb, 4H]`` projection never exists in device memory.  As there,
the plain call (inference) writes no cell-state stash; when an input needs
a gradient, the call goes through a ``torch.autograd.Function`` whose
forward also writes the stash ``cs`` and whose backward recomputes the
gates from ``(x, h_prev)``.  :func:`plan` picks one of the source's two
designs per shape (thread-block clusters, or waves of 16-row CTAs on the
gate product at the sub band's many rows); the designs and what bounds
them are described at the top of the source.

Two forms, as the Pallas kernel has: f32, and the bf16-stream form, in
which ``x``, ``ys``, their cotangent ``dys`` and the gradient ``dx`` are
bf16 while the projection (``x`` upcast, f32 ``w_ih_t``), the carry, the
gate math, the stash and the weight and bias gradients stay f32
(``pallas_lstm.py:318-321``).  The plain versions take the form from
``x``'s dtype; each kernel form has its own C entry and its own launch
count (``launches``, ``launches_bf16``).

The cell-state stash is f32, or bf16 where ``cs_dtype`` (a keyword of
:func:`fused_lstm_scan_inproj` and of its backward) or, by default,
:data:`CS_STASH_DTYPE` says so, as the Pallas kernel's ``cs_dtype``
(``pallas_lstm.py:32-41``, ``:432-434``).  In bf16 each stored ``c`` is
rounded to nearest even; the carry, ``cT`` and ``c_prev`` at t = 0 (from
``c0``) stay f32, and the backward reads ``c_t`` and ``c_prev`` at t > 0
back from the rounded stash.  The stash entries count on
``launches_cs16`` and ``launches_bf16_cs16``.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..probes import gate_product as gp
from ..probes.gate_product import wave_plan
from . import build
from .cluster_plan import MAX_SMEM, Plan, cell_threads, smem_bytes  # noqa: F401 (K2's tiling)
from .cluster_plan import plan as _cluster_plan

# Storage dtype of the cell-state stash that a call with gradients writes
# for its backward, read at import from the variable the JAX package reads:
# SE_TPU_LSTM_CS_STASH=bfloat16 halves the stash's bytes; anything else
# keeps it f32 (the default: gradients bit-stable).
CS_STASH_DTYPE = (
    torch.bfloat16 if os.environ.get("SE_TPU_LSTM_CS_STASH") == "bfloat16" else torch.float32
)
# the suffix of a stash form's C entry and launch count
_STASH_FORMS = {torch.float32: "", torch.bfloat16: "_cs16"}


def _stash_dtype(cs_dtype):
    cs_dtype = CS_STASH_DTYPE if cs_dtype is None else cs_dtype
    if cs_dtype not in _STASH_FORMS:
        raise TypeError(f"the cell-state stash must be float32 or bfloat16, got {cs_dtype}")
    return cs_dtype


# The wave design is taken where it busies at least this many CTAs (16-row
# tiles over the L stacks), a third of the H100's 132 SMs, and H, rounded
# up to whole warps, is WAVE_MIN_UNITS to gate_product.MAX_UNITS.  Its
# step costs the same whatever the rows, so with fewer CTAs the cluster
# design, which runs few rows in few waves, measured faster: FullSubNet's
# sub band at B = 1 and 2 (17 and 33 CTAs) and a stream's chunk, both
# layers and directions but sb l1's forward at B = 2 (19.3 against 20.1 ms
# on clusters); the wave design from B = 3 (49 CTAs; PERF.md §6).
WAVE_MIN_CTAS = 44


def cluster_tiling(Bb: int, In: int, H: int, backward: bool = False) -> Plan:
    """The cluster design's tiling of a K2 launch (forward, or the
    backward's reverse scan): :func:`cluster_plan.plan` at four gates.  The
    W_hh slice is resident wherever a tile of 4 rows fits beside it, else
    streamed from L2."""
    return _cluster_plan(Bb, In, H, backward, gates=4)


def plan(Bb: int, In: int, H: int, backward: bool = False, L: int = 1):
    """The design and tiling of a K2 launch over ``L`` stacks, ``design``
    one of:

    - ``"wave"`` (a ``gate_product.WavePlan``, K3's wave tiling) where its 16-row
      tiles over the L stacks number ``WAVE_MIN_CTAS`` or more and H,
      rounded up to whole warps, is ``WAVE_MIN_UNITS`` to
      ``gate_product.MAX_UNITS``: FullSubNet's sub band from B = 3;
    - ``"cluster"``: :func:`cluster_tiling` elsewhere: CRN, DCCRN's real
      LSTM, the full band (H = 512), the sub band at B = 1 and 2 and a
      stream's chunk."""
    if (gp.WAVE_MIN_UNITS - gp.UNITS_PER_WARP < H <= gp.MAX_UNITS
            and L * -(-Bb // gp.TILE_ROWS) >= WAVE_MIN_CTAS):
        return wave_plan(Bb, In, H, backward, L)
    return cluster_tiling(Bb, In, H, backward)


def active_clusters(Bb: int, In: int, H: int, backward: bool = False, device=None,
                    L: int = 1) -> int:
    """How many clusters of :func:`plan`'s design and tiling fit on the CUDA
    ``device`` at once (the runtime's occupancy query; 0: none, and a
    launch raises)."""
    p = plan(Bb, In, H, backward, L)
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _library()
    if p.design == "wave":
        n = lib.se_lstm_wave_active_clusters(int(backward), In, H, *p.args(), index)
    else:
        n = lib.se_lstm_inproj_active_clusters(int(backward), In, H, *p.args(), index)
    if n < 0:
        msg = lib.se_cuda_error_string(-n).decode()
        raise RuntimeError(f"K2 occupancy query failed: CUDA error {-n} ({msg})")
    return n


def wave_layout(w_ih_t, bias, w_hh_t, In_p: int, Hp: int) -> tuple:
    """``(w [L, In_p + Hp, 4 Hp], bias [L, 4 Hp])``, f32: the weights as
    the wave kernels read them, each row's columns unit-major (``4 u + g``,
    gates i, f, g, o): rows k < In hold W_ih, rows In_p + i, i < H, W_hh;
    zeros past In and H.  The bias is the combined ``b_ih + b_hh`` the
    wrapper receives, in the same column order."""
    L, In, _ = w_ih_t.shape
    H = w_hh_t.shape[1]
    w = torch.zeros((L, In_p + Hp, 4 * Hp), device=w_ih_t.device, dtype=torch.float32)
    w[:, :In] = gp.unit_major(w_ih_t.float(), Hp)
    w[:, In_p:In_p + H] = gp.unit_major(w_hh_t.float(), Hp)
    return w, gp.unit_major(bias.float(), Hp).contiguous()


def wave_transpose(w_hh_t, Hp: int) -> torch.Tensor:
    """``wt [L, Hp, 4 Hp]``, f32: W_hh^T as the wave backward's dh product
    reads it.  W_hh^T's 4 Hp rows k' = g Hp + j (gate g, unit j; zero past
    H) fall into four parts of Hp rows, one a gate; row j of wt holds, for
    each unit i, the four gates' rows side by side (column ``4 i + g``), so
    dh[i] = sum over g and j of dgates[g Hp + j] wt[j][4 i + g]."""
    L, H, _ = w_hh_t.shape
    t = torch.zeros((L, 4, Hp, Hp), device=w_hh_t.device, dtype=torch.float32)  # [L, g, j, i]
    t[:, :, :H, :H] = w_hh_t.float().reshape(L, H, 4, H).permute(0, 2, 3, 1)
    return t.permute(0, 2, 3, 1).reshape(L, Hp, 4 * Hp).contiguous()


def _gates(x_t, w_ih_t, bias, h, w_hh_t):
    return torch.bmm(x_t, w_ih_t) + torch.bmm(h, w_hh_t) + bias[:, None, :]


def _reference_forward(x, w_ih_t, bias, w_hh_t, h0, c0, need_cs, cs_dtype=torch.float32):
    """The plain recurrence -> ``(ys, cs or None, hT, cT)``, the stash in
    ``cs_dtype`` (each f32 ``c`` rounded to it; the carry stays f32)."""
    H = h0.shape[-1]
    h, c = h0.float(), c0.float()
    w_ih, w_hh, b = w_ih_t.float(), w_hh_t.float(), bias.float()
    ys, cs = [], []
    for t in range(x.shape[0]):
        gates = _gates(x[t].float(), w_ih, b, h, w_hh)
        i = torch.sigmoid(gates[..., 0 * H : 1 * H])
        f = torch.sigmoid(gates[..., 1 * H : 2 * H])
        g = torch.tanh(gates[..., 2 * H : 3 * H])
        o = torch.sigmoid(gates[..., 3 * H : 4 * H])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h.to(x.dtype))
        if need_cs:
            cs.append(c.to(cs_dtype))
    return torch.stack(ys), torch.stack(cs) if need_cs else None, h, c


def fused_lstm_scan_inproj_reference(x, w_ih_t, bias, w_hh_t, h0, c0):
    """The plain recurrence: ``x [T, L, Bb, In]``, ``w_ih_t [L, In, 4H]``,
    ``bias [L, 4H]`` (``b_ih + b_hh``), ``w_hh_t [L, H, 4H]``,
    ``h0``/``c0 [L, Bb, H]`` -> ``(ys [T, L, Bb, H] in x's dtype, (hT, cT)
    f32)``.  Gate order i, f, g, o; the carry and the gate math are f32."""
    ys, _, hT, cT = _reference_forward(x, w_ih_t, bias, w_hh_t, h0, c0, need_cs=False)
    return ys, (hT, cT)


def fused_lstm_scan_inproj_backward_reference(x, w_ih_t, bias, w_hh_t, h0, c0,
                                              ys, cs, dys, dhT, dcT):
    """The plain backward, step by step as the Pallas ``_bwd_inproj_kernel``:
    the forward's inputs, its ``ys`` and stash ``cs [T, L, Bb, H]`` (f32 or
    bf16, widened as it is read), and the cotangents of ``(ys, hT, cT)`` ->
    ``(dx, dw_ih_t, dbias, dw_hh_t, dh0, dc0)``."""
    T = x.shape[0]
    H = h0.shape[-1]
    w_ih, w_hh, b = w_ih_t.float(), w_hh_t.float(), bias.float()
    dh, dc = dhT.float(), dcT.float()
    dw_ih, dw_hh = torch.zeros_like(w_ih), torch.zeros_like(w_hh)
    db = torch.zeros_like(b)
    dxs = []
    for t in range(T - 1, -1, -1):
        x_t = x[t].float()
        h_prev = h0 if t == 0 else ys[t - 1].float()
        c_prev = c0 if t == 0 else cs[t - 1].float()
        gates = _gates(x_t, w_ih, b, h_prev, w_hh)
        i = torch.sigmoid(gates[..., 0 * H : 1 * H])
        f = torch.sigmoid(gates[..., 1 * H : 2 * H])
        g = torch.tanh(gates[..., 2 * H : 3 * H])
        o = torch.sigmoid(gates[..., 3 * H : 4 * H])
        tanh_c = torch.tanh(cs[t].float())
        dh = dys[t].float() + dh
        do = dh * tanh_c * o * (1.0 - o)
        dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
        di = dc * g * i * (1.0 - i)
        df = dc * c_prev * f * (1.0 - f)
        dg = dc * i * (1.0 - g * g)
        dgates = torch.cat([di, df, dg, do], dim=-1)  # [L, Bb, 4H]
        dxs.append(torch.bmm(dgates, w_ih.transpose(1, 2)).to(x.dtype))
        dw_ih = dw_ih + torch.bmm(x_t.transpose(1, 2), dgates)
        db = db + dgates.sum(1)
        dw_hh = dw_hh + torch.bmm(h_prev.transpose(1, 2), dgates)
        dh = torch.bmm(dgates, w_hh.transpose(1, 2))
        dc = dc * f
    return torch.stack(dxs[::-1]), dw_ih, db, dw_hh, dh, dc


def _check(x, w_ih_t, bias, w_hh_t, h0, c0):
    if x.ndim != 4:
        raise ValueError(f"x must be [T, L, Bb, In], got {tuple(x.shape)}")
    T, L, Bb, In = x.shape
    if T < 1:
        raise ValueError("x must hold at least one step")
    if w_hh_t.ndim != 3 or w_hh_t.shape[-1] != 4 * w_hh_t.shape[-2]:
        raise ValueError(f"w_hh_t must be [L, H, 4H], got {tuple(w_hh_t.shape)}")
    H = w_hh_t.shape[1]
    G = 4 * H
    want = {"w_ih_t": (L, In, G), "bias": (L, G), "w_hh_t": (L, H, G),
            "h0": (L, Bb, H), "c0": (L, Bb, H)}
    named = (("x", x), ("w_ih_t", w_ih_t), ("bias", bias), ("w_hh_t", w_hh_t),
             ("h0", h0), ("c0", c0))
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    build.check_dtypes([(name, t, name == "x") for name, t in named], x.dtype)
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _library():
    """The built kernel library, with its C signatures declared."""
    lib = build.load("lstm_inproj")
    if lib.se_lstm_inproj_fwd_f32.argtypes is None:
        for form in build.STREAM_FORMS.values():
            for stash in _STASH_FORMS.values():
                fwd = getattr(lib, f"se_lstm_inproj_fwd_{form}{stash}")
                bwd = getattr(lib, f"se_lstm_inproj_bwd_{form}{stash}")
                fwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
                bwd.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
                wfwd = getattr(lib, f"se_lstm_wave_fwd_{form}{stash}")
                wbwd = getattr(lib, f"se_lstm_wave_bwd_{form}{stash}")
                wfwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
                wbwd.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
                fwd.restype = bwd.restype = wfwd.restype = wbwd.restype = ctypes.c_int
        lib.se_lstm_inproj_active_clusters.argtypes = [ctypes.c_int] * 8
        lib.se_lstm_inproj_active_clusters.restype = ctypes.c_int
        lib.se_lstm_wave_active_clusters.argtypes = [ctypes.c_int] * 7
        lib.se_lstm_wave_active_clusters.restype = ctypes.c_int
    return lib


_INPUTS = ("x", "w_ih_t", "bias", "w_hh_t", "h0", "c0")


def _forward(x, w_ih_t, bias, w_hh_t, h0, c0, need_cs, cs_dtype=None):
    """``(ys, cs or None, hT, cT)``, the stash in ``cs_dtype`` (None:
    :data:`CS_STASH_DTYPE`): the plain version for CPU tensors, the forward
    kernel for CUDA tensors (counted on ``fused_lstm_scan_inproj``, a bf16
    stash on ``launches_cs16`` or ``launches_bf16_cs16``)."""
    cs_dtype = _stash_dtype(cs_dtype)
    dev = x.device
    if dev.type == "cpu":
        return _reference_forward(x, w_ih_t, bias, w_hh_t, h0, c0, need_cs, cs_dtype)
    T, L, Bb, In = x.shape
    H = h0.shape[-1]
    sdt, f32 = x.dtype, torch.float32
    new = lambda *shape: torch.empty(shape, device=dev, dtype=f32)
    ys = torch.empty((T, L, Bb, H), device=dev, dtype=sdt)
    hT, cT = new(L, Bb, H), new(L, Bb, H)
    # no stash, no stash form: the inference launch is the f32-stash entry's
    stash = _STASH_FORMS[cs_dtype] if need_cs else ""
    cs = torch.empty((T, L, Bb, H), device=dev, dtype=cs_dtype) if need_cs else None
    p, form = plan(Bb, In, H, L=L), build.STREAM_FORMS[sdt]
    if p.design == "wave":
        w, b = wave_layout(w_ih_t, bias, w_hh_t, p.In_p, p.Hp)
        build.cuda_launch(_library(), f"se_lstm_wave_fwd_{form}{stash}", (x, w, b, h0, c0),
                          ("x", "w", "bias", "h0", "c0"), (ys, cs, hT, cT),
                          (T, L, Bb, In, H, *p.args()), dev, (sdt,) + (f32,) * 4)
    else:
        build.cuda_launch(_library(), f"se_lstm_inproj_fwd_{form}{stash}",
                          (x, w_ih_t, bias, w_hh_t, h0, c0), _INPUTS, (ys, cs, hT, cT),
                          (T, L, Bb, In, H, *p.args()), dev, (sdt,) + (f32,) * 5)
    build.count_launch(fused_lstm_scan_inproj, sdt, stash)
    return ys, cs, hT, cT


def fused_lstm_scan_inproj_backward(x, w_ih_t, bias, w_hh_t, h0, c0, ys, cs, dys, dhT, dcT,
                                    cs_dtype=None):
    """Same signature and result as
    :func:`fused_lstm_scan_inproj_backward_reference`; a cotangent given as
    None counts as zeros.  ``cs`` must be in ``cs_dtype`` (None:
    :data:`CS_STASH_DTYPE`), float32 or bfloat16.

    CPU tensors run the plain version.  CUDA tensors launch the backward
    kernels (the reverse scan in :func:`plan`'s design, then the
    deterministic dx product and dW_ih, dW_hh and dbias reductions over an
    f32 ``[T, L, Bb, 4H]`` dgates scratch buffer) on the current stream, or
    raise: contiguous only; x, ys and dys all
    float32 or all bfloat16 (then dx is bfloat16 too), the rest float32
    but the stash.  Each call that launches adds one to
    ``fused_lstm_scan_inproj_backward.launches`` (f32) or ``.launches_bf16``,
    with a bf16 stash to ``.launches_cs16`` or ``.launches_bf16_cs16``.
    """
    _check(x, w_ih_t, bias, w_hh_t, h0, c0)
    T, L, Bb, In = x.shape
    H = h0.shape[-1]
    G = 4 * H
    sdt, f32 = x.dtype, torch.float32
    zeros = lambda shape, dtype=f32: torch.zeros(shape, device=x.device, dtype=dtype)
    dys = zeros((T, L, Bb, H), sdt) if dys is None else dys
    dhT = zeros((L, Bb, H)) if dhT is None else dhT
    dcT = zeros((L, Bb, H)) if dcT is None else dcT
    named = (("ys", ys, (T, L, Bb, H), True), ("cs", cs, (T, L, Bb, H), False),
             ("dys", dys, (T, L, Bb, H), True), ("dhT", dhT, (L, Bb, H), False),
             ("dcT", dcT, (L, Bb, H), False))
    for name, t, shape, _ in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    build.check_dtypes([(n, t, s) for n, t, _, s in named if n != "cs"], sdt)
    cs_dtype = _stash_dtype(cs_dtype)
    if cs.dtype != cs_dtype:
        raise TypeError(f"cs must be {cs_dtype}, got {cs.dtype}")
    stash = _STASH_FORMS[cs_dtype]
    dev = x.device
    if dev.type == "cpu":
        return fused_lstm_scan_inproj_backward_reference(
            x, w_ih_t, bias, w_hh_t, h0, c0, ys, cs, dys, dhT, dcT
        )
    new = lambda *shape: torch.empty(shape, device=dev, dtype=f32)
    dx = torch.empty((T, L, Bb, In), device=dev, dtype=sdt)
    dw_ih, db, dw_hh = new(L, In, G), new(L, G), new(L, H, G)
    dh0, dc0, scratch = new(L, Bb, H), new(L, Bb, H), new(T, L, Bb, G)
    outs = (dx, dw_ih, db, dw_hh, dh0, dc0, scratch, build.dw_workspace(dev))
    p, form = plan(Bb, In, H, backward=True, L=L), build.STREAM_FORMS[sdt]
    if p.design == "wave":
        w, b = wave_layout(w_ih_t, bias, w_hh_t, p.In_p, p.Hp)
        wt = wave_transpose(w_hh_t, p.Hp)
        build.cuda_launch(
            _library(), f"se_lstm_wave_bwd_{form}{stash}",
            (x, w, b, wt, h0, c0, ys, cs, dys, dhT, dcT, w_ih_t),
            ("x", "w", "bias", "wt", "h0", "c0", "ys", "cs", "dys", "dhT", "dcT", "w_ih_t"),
            outs, (T, L, Bb, In, H, *p.args(), build.DW_WORKSPACE_FLOATS), dev,
            (sdt,) + (f32,) * 5 + (sdt, cs_dtype, sdt, f32, f32, f32))
    else:
        # [L, 4H, H], read only by the dh pass of a streamed slice (else unread)
        w_hh = w_hh_t if p.resident else w_hh_t.transpose(1, 2).contiguous()
        build.cuda_launch(
            _library(), f"se_lstm_inproj_bwd_{form}{stash}",
            (x, w_ih_t, bias, w_hh_t, w_hh, h0, c0, ys, cs, dys, dhT, dcT),
            ("x", "w_ih_t", "bias", "w_hh_t", "w_hh", "h0", "c0", "ys", "cs", "dys", "dhT", "dcT"),
            outs, (T, L, Bb, In, H, *p.args(), build.DW_WORKSPACE_FLOATS),
            dev, (sdt,) + (f32,) * 6 + (sdt, cs_dtype, sdt, f32, f32),
        )
    build.count_launch(fused_lstm_scan_inproj_backward, sdt, stash)
    return dx, dw_ih, db, dw_hh, dh0, dc0


class _FusedLstmScanInproj(torch.autograd.Function):
    """The custom VJP of ``pallas_lstm.fused_lstm_scan_inproj``: the forward
    keeps ``(x, w_ih_t, bias, w_hh_t, h0, c0, ys, cs)``; the backward maps
    ``(dys, dhT, dcT)``, zeros where an output was unused, to the six input
    gradients (and None for ``cs_dtype``)."""

    @staticmethod
    def forward(ctx, x, w_ih_t, bias, w_hh_t, h0, c0, cs_dtype):
        ys, cs, hT, cT = _forward(x, w_ih_t, bias, w_hh_t, h0, c0, True, cs_dtype)
        ctx.save_for_backward(x, w_ih_t, bias, w_hh_t, h0, c0, ys, cs)
        ctx.cs_dtype = cs_dtype
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        cont = lambda t: None if t is None else t.contiguous()
        grads = fused_lstm_scan_inproj_backward(
            *ctx.saved_tensors, cont(dys), cont(dhT), cont(dcT), cs_dtype=ctx.cs_dtype
        )
        return (*grads, None)


def fused_lstm_scan_inproj(x, w_ih_t, bias, w_hh_t, h0, c0, *, cs_dtype=None):
    """Same signature and result as :func:`fused_lstm_scan_inproj_reference`.

    CPU tensors run the plain version.  CUDA tensors launch the kernel in
    :func:`plan`'s design on the current stream, or raise: contiguous only, x float32 or bfloat16
    (the bf16-stream form: ys bfloat16), the rest float32.  Each launch adds
    one to ``fused_lstm_scan_inproj.launches`` (f32) or ``.launches_bf16``.
    When gradients are on
    and an input requires one, the call also writes the cell-state stash,
    in ``cs_dtype`` (None: :data:`CS_STASH_DTYPE`), and its backward is
    :func:`fused_lstm_scan_inproj_backward`; otherwise no stash is
    allocated.
    """
    args = (x, w_ih_t, bias, w_hh_t, h0, c0)
    _check(*args)
    cs_dtype = _stash_dtype(cs_dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        ys, hT, cT = _FusedLstmScanInproj.apply(*args, cs_dtype)
        return ys, (hT, cT)
    ys, _, hT, cT = _forward(*args, need_cs=False)
    return ys, (hT, cT)


for _fn in (fused_lstm_scan_inproj, fused_lstm_scan_inproj_backward):
    _fn.launches = _fn.launches_bf16 = _fn.launches_cs16 = _fn.launches_bf16_cs16 = 0
