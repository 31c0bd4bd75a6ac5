"""Fused GRU scan with the input projection inside the kernel: the
hand-written CUDA kernels ``csrc/gru_inproj.cu`` (forward and backward)
and their plain PyTorch versions.

Counterpart of ``fused_gru_scan_inproj`` in ``se_tpu/ops/pallas_lstm.py``:
one torch-semantics GRU layer (gate order r, z, n; ``n = tanh(xp_n + r *
hp_n)``, so ``b_ih`` and ``b_hh`` stay separate), the ``[T, Bb, 3H]``
projection formed per step inside the kernel.  The only stash is ``ys``:
when an input needs a gradient, the call goes through a
``torch.autograd.Function`` whose backward recomputes the gates from
``(x, h_prev)``.  The kernels' design and what bounds them are described
at the top of their source.

Two forms, as the Pallas kernel has: f32, and the bf16-stream form, in
which ``x``, ``ys``, their cotangent ``dys`` and the gradient ``dx`` are
bf16 while the projection (``x`` upcast, f32 ``w_ih_t``), the carry, the
gate math and the weight, bias and state gradients stay f32
(``pallas_lstm.py:614, :618, :643, :667``); the backward recomputes from
the rounded ``ys``.  The plain versions take the form from ``x``'s dtype;
each kernel form has its own C entry and its own launch count
(``launches``, ``launches_bf16``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..probes import gate_product as gp
from ..probes.gate_product import (  # noqa: F401 (the wave design's tiling, shared with K2)
    WAVE_CLUSTER,
    WAVE_MAX_STAGES,
    WAVE_MIN_UNITS,
    WavePlan,
    wave_plan,
    wave_smem,
)
from . import build
from .cluster_plan import ROW_QUANTUM, Plan
from .cluster_plan import plan as _cluster_plan


# The most clusters a stack that K3 runs on clusters.  An H100 runs 7
# clusters of 16 CTAs of ~220 KiB each at once (the occupancy query,
# PERF.md); past that the clusters run in waves, each wave the whole chain
# of T steps, and the designs whose CTAs all run at once measured faster
# (FullSubNet-GRU's sub band, both directions, PERF.md §6).
CLUSTER_TILES = 7
# The H100's SMs: the per-block kernel runs one block an SM, its blocks of
# 4 rows or, where those outnumber the SMs, 8 (``row_tile`` in the source,
# which asks the device).
SMS = 132


def block_tiles(Bb: int, L: int = 1) -> int:
    """The per-block kernel's blocks: tiles of 4 rows, or of 8 where those
    outnumber ``SMS`` (``row_tile`` in the source), over the L stacks."""
    R = 8 if L * -(-Bb // 4) > SMS else 4
    return L * -(-Bb // R)


def cluster_tiling(Bb: int, In: int, H: int, backward: bool = False) -> Plan:
    """The cluster design's tiling: :func:`cluster_plan.plan` at three
    gates, its tiles as narrow as ``CLUSTER_TILES`` clusters allow (a step's
    FMA chain, not the slice's reuse over rows, bounds it)."""
    rows = ROW_QUANTUM * -(-Bb // (ROW_QUANTUM * CLUSTER_TILES))  # for CLUSTER_TILES tiles
    return _cluster_plan(Bb, In, H, backward, gates=3, max_rows=rows)


def plan(Bb: int, In: int, H: int, backward: bool = False, L: int = 1):
    """The design and tiling of a K3 launch (forward, or the backward's
    reverse scan) over ``L`` stacks, ``design`` one of:

    - ``"cluster"``: :func:`cluster_tiling`, where the W_hh slice is
      resident and the tiles number at most ``CLUSTER_TILES``:
      FullSubNet-GRU's full band;
    - ``"wave"`` (a :class:`WavePlan`) where the per-block kernel's blocks
      would not all run at once (``block_tiles`` > ``SMS``) and H, rounded
      up to whole warps, is ``WAVE_MIN_UNITS`` to ``gate_product.MAX_UNITS``:
      the sub band at B = 5 and more (one wave up to B = 8, two at 9 and
      10);
    - ``"block"`` elsewhere, the per-block kernel, which picks its own tile
      and chunk (the tiling fields unread): the sub band at B = 1 to 4 and
      a stream's chunk, where its blocks of 4 or 8 rows all run at once and
      the wave design's 16-row CTAs leave most of the card idle (PERF.md
      §6)."""
    p = cluster_tiling(Bb, In, H, backward)
    if p.resident and p.tiles <= CLUSTER_TILES:
        return p
    if WAVE_MIN_UNITS - gp.UNITS_PER_WARP < H <= gp.MAX_UNITS and block_tiles(Bb, L) > SMS:
        return wave_plan(Bb, In, H, backward, L)
    return dataclasses.replace(p, design="block")


def active_clusters(Bb: int, In: int, H: int, backward: bool = False, device=None,
                    L: int = 1) -> int:
    """How many clusters of :func:`plan`'s design and tiling (cluster or
    wave) for ``L`` stacks fit on the CUDA ``device`` at once (the
    runtime's occupancy query; 0: none, and the launch raises)."""
    p = plan(Bb, In, H, backward, L)
    if p.design == "block":
        raise ValueError(f"K3 runs no clusters at Bb={Bb}, In={In}, H={H}: the per-block design")
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _library()
    if p.design == "wave":
        n = lib.se_gru_wave_active_clusters(int(backward), In, H, *p.args(), index)
    else:
        n = lib.se_gru_inproj_active_clusters(int(backward), In, H, p.R, p.N, p.C, index)
    if n < 0:
        msg = lib.se_cuda_error_string(-n).decode()
        raise RuntimeError(f"K3 occupancy query failed: CUDA error {-n} ({msg})")
    return n


def _tiling(p: Plan) -> tuple:
    """The cluster entries' design and tiling arguments ``(cluster, R, N, C)``
    (cluster 0: the per-block kernel)."""
    return int(p.design == "cluster"), p.R, p.N, p.C


def wave_layout(w_ih_t, b_ih, w_hh_t, b_hh, In_p: int, Hp: int) -> tuple:
    """``(w [L, In_p + Hp, 4 Hp], bias [L, 4 Hp])``, f32: the weights as
    the wave kernels read them, each row's columns unit-major (``4 u + c``)
    in the accumulator order c = (r, z, n_x, n_h).  Rows k < In hold W_ih's
    r, z and n (n in n_x, 0 in n_h); rows In_p + i, i < H, hold W_hh's r,
    z, 0 and n (n in n_h); zeros past In and H.  The bias folds ``b_ih +
    b_hh`` on r and z and keeps ``b_ih``'s n (n_x) and ``b_hh``'s (n_h)
    apart: n = tanh(n_x + r n_h)."""
    L, In, G = w_ih_t.shape
    H = G // 3
    f32 = torch.float32
    w = torch.zeros((L, In_p + Hp, Hp, 4), device=w_ih_t.device, dtype=f32)
    wi = w_ih_t.to(f32).reshape(L, In, 3, H).transpose(2, 3)  # [L, k, unit, gate]
    wh = w_hh_t.to(f32).reshape(L, H, 3, H).transpose(2, 3)
    w[:, :In, :H, :3] = wi
    w[:, In_p:In_p + H, :H, :2] = wh[..., :2]
    w[:, In_p:In_p + H, :H, 3] = wh[..., 2]
    bi, bh = b_ih.to(f32).reshape(L, 3, H), b_hh.to(f32).reshape(L, 3, H)
    bias = torch.zeros((L, Hp, 4), device=w_ih_t.device, dtype=f32)
    bias[:, :H, :2] = (bi[:, :2] + bh[:, :2]).transpose(1, 2)
    bias[:, :H, 2] = bi[:, 2]
    bias[:, :H, 3] = bh[:, 2]
    return w.reshape(L, In_p + Hp, 4 * Hp), bias.reshape(L, 4 * Hp)


def wave_transpose(w_hh_t, Hp: int) -> torch.Tensor:
    """``wt [L, 3 Hp / 4, 4 Hp]``, f32: W_hh^T as the wave backward's dh
    product reads it.  W_hh^T's 3 Hp rows k' = g Hp + j (gate g, unit j;
    zero past H) fall into four parts of Q = 3 Hp / 4; row kq of wt holds,
    for each unit i, the four parts' rows ``p Q + kq`` side by side (column
    ``4 i + p``), so dh[i] = sum over p and kq of dhp[p Q + kq] wt[kq][4 i
    + p]."""
    L, H, _ = w_hh_t.shape
    t = torch.zeros((L, 3, Hp, Hp), device=w_hh_t.device, dtype=torch.float32)  # [L, g, j, i]
    t[:, :, :H, :H] = w_hh_t.to(torch.float32).reshape(L, H, 3, H).permute(0, 2, 3, 1)
    Q = 3 * Hp // 4
    return t.reshape(L, 4, Q, Hp).permute(0, 2, 3, 1).reshape(L, Q, 4 * Hp).contiguous()


def _gates(x_t, w_ih_t, b_ih, h, w_hh_t, b_hh, H):
    """``(r, z, n, hp_n)`` of one step, as the Pallas ``_gru_gates``."""
    xp = torch.bmm(x_t, w_ih_t) + b_ih[:, None, :]
    hp = torch.bmm(h, w_hh_t) + b_hh[:, None, :]
    r = torch.sigmoid(xp[..., :H] + hp[..., :H])
    z = torch.sigmoid(xp[..., H : 2 * H] + hp[..., H : 2 * H])
    hp_n = hp[..., 2 * H :]
    n = torch.tanh(xp[..., 2 * H :] + r * hp_n)
    return r, z, n, hp_n


def fused_gru_scan_inproj_reference(x, w_ih_t, b_ih, w_hh_t, b_hh, h0):
    """The plain recurrence, the loop of ``rnn.gru``'s scan: ``x [T, L, Bb,
    In]``, ``w_ih_t [L, In, 3H]``, ``b_ih``/``b_hh [L, 3H]``, ``w_hh_t [L,
    H, 3H]``, ``h0 [L, Bb, H]`` -> ``(ys [T, L, Bb, H] in x's dtype, hT
    f32)``.  The carry and the gate math are f32."""
    H = h0.shape[-1]
    h = h0.float()
    w_ih, w_hh = w_ih_t.float(), w_hh_t.float()
    bi, bh = b_ih.float(), b_hh.float()
    ys = []
    for t in range(x.shape[0]):
        _, z, n, _ = _gates(x[t].float(), w_ih, bi, h, w_hh, bh, H)
        h = (1.0 - z) * n + z * h
        ys.append(h.to(x.dtype))
    return torch.stack(ys), h


def fused_gru_scan_inproj_backward_reference(x, w_ih_t, b_ih, w_hh_t, b_hh, h0, ys, dys, dhT):
    """The plain backward, step by step as the Pallas ``_bwd_gru_kernel``:
    the forward's inputs, its ``ys`` and the cotangents of ``(ys, hT)`` ->
    ``(dx, dw_ih_t, db_ih, dw_hh_t, db_hh, dh0)``."""
    H = h0.shape[-1]
    w_ih, w_hh = w_ih_t.float(), w_hh_t.float()
    bi, bh = b_ih.float(), b_hh.float()
    dh = dhT.float()
    dw_ih, dw_hh = torch.zeros_like(w_ih), torch.zeros_like(w_hh)
    db_ih, db_hh = torch.zeros_like(bi), torch.zeros_like(bh)
    dxs = []
    for t in range(x.shape[0] - 1, -1, -1):
        x_t = x[t].float()
        h_prev = h0.float() if t == 0 else ys[t - 1].float()
        r, z, n, hp_n = _gates(x_t, w_ih, bi, h_prev, w_hh, bh, H)
        dh = dys[t].float() + dh
        da_z = dh * (h_prev - n) * z * (1.0 - z)
        da_n = dh * (1.0 - z) * (1.0 - n * n)
        da_r = da_n * hp_n * r * (1.0 - r)
        dxp = torch.cat([da_r, da_z, da_n], dim=-1)  # [L, Bb, 3H]
        dhp = torch.cat([da_r, da_z, da_n * r], dim=-1)
        dxs.append(torch.bmm(dxp, w_ih.transpose(1, 2)).to(x.dtype))
        dw_ih = dw_ih + torch.bmm(x_t.transpose(1, 2), dxp)
        db_ih = db_ih + dxp.sum(1)
        dw_hh = dw_hh + torch.bmm(h_prev.transpose(1, 2), dhp)
        db_hh = db_hh + dhp.sum(1)
        dh = dh * z + torch.bmm(dhp, w_hh.transpose(1, 2))
    return torch.stack(dxs[::-1]), dw_ih, db_ih, dw_hh, db_hh, dh


_INPUTS = ("x", "w_ih_t", "b_ih", "w_hh_t", "b_hh", "h0")


def _check(x, w_ih_t, b_ih, w_hh_t, b_hh, h0):
    if x.ndim != 4:
        raise ValueError(f"x must be [T, L, Bb, In], got {tuple(x.shape)}")
    T, L, Bb, In = x.shape
    if T < 1:
        raise ValueError("x must hold at least one step")
    if w_hh_t.ndim != 3 or w_hh_t.shape[-1] != 3 * w_hh_t.shape[-2]:
        raise ValueError(f"w_hh_t must be [L, H, 3H], got {tuple(w_hh_t.shape)}")
    H = w_hh_t.shape[1]
    G = 3 * H
    want = {"w_ih_t": (L, In, G), "b_ih": (L, G), "w_hh_t": (L, H, G), "b_hh": (L, G),
            "h0": (L, Bb, H)}
    named = tuple(zip(_INPUTS, (x, w_ih_t, b_ih, w_hh_t, b_hh, h0)))
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    build.check_dtypes([(name, t, name == "x") for name, t in named], x.dtype)
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _library():
    """The built kernel library, with its C signatures declared."""
    lib = build.load("gru_inproj")
    if lib.se_gru_inproj_fwd_f32.argtypes is None:
        for form in build.STREAM_FORMS.values():
            fwd = getattr(lib, f"se_gru_inproj_fwd_{form}")
            bwd = getattr(lib, f"se_gru_inproj_bwd_{form}")
            fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
            bwd.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
            fwd.restype = bwd.restype = ctypes.c_int
        for form in build.STREAM_FORMS.values():
            fwd = getattr(lib, f"se_gru_wave_fwd_{form}")
            bwd = getattr(lib, f"se_gru_wave_bwd_{form}")
            fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
            bwd.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
            fwd.restype = bwd.restype = ctypes.c_int
        for query in ("se_gru_inproj_active_clusters", "se_gru_wave_active_clusters"):
            getattr(lib, query).argtypes = [ctypes.c_int] * 7
            getattr(lib, query).restype = ctypes.c_int
    return lib


def _forward(x, w_ih_t, b_ih, w_hh_t, b_hh, h0):
    """``(ys, hT)``: the plain version for CPU tensors, the forward kernel
    for CUDA tensors (counted on ``fused_gru_scan_inproj``)."""
    dev = x.device
    if dev.type == "cpu":
        return fused_gru_scan_inproj_reference(x, w_ih_t, b_ih, w_hh_t, b_hh, h0)
    T, L, Bb, In = x.shape
    H = h0.shape[-1]
    sdt, f32 = x.dtype, torch.float32
    ys = torch.empty((T, L, Bb, H), device=dev, dtype=sdt)
    hT = torch.empty((L, Bb, H), device=dev, dtype=f32)
    p, form = plan(Bb, In, H, L=L), build.STREAM_FORMS[sdt]
    if p.design == "wave":
        w, bias = wave_layout(w_ih_t, b_ih, w_hh_t, b_hh, p.In_p, p.Hp)
        build.cuda_launch(_library(), f"se_gru_wave_fwd_{form}", (x, w, bias, h0),
                          ("x", "w", "bias", "h0"), (ys, hT), (T, L, Bb, In, H, *p.args()),
                          dev, (sdt, f32, f32, f32))
    else:
        build.cuda_launch(_library(), f"se_gru_inproj_fwd_{form}",
                          (x, w_ih_t, b_ih, w_hh_t, b_hh, h0), _INPUTS, (ys, hT),
                          (T, L, Bb, In, H, *_tiling(p)), dev, (sdt,) + (f32,) * 5)
    build.count_launch(fused_gru_scan_inproj, sdt)
    return ys, hT


def fused_gru_scan_inproj_backward(x, w_ih_t, b_ih, w_hh_t, b_hh, h0, ys, dys, dhT):
    """Same signature and result as
    :func:`fused_gru_scan_inproj_backward_reference`; a cotangent given as
    None counts as zeros.

    CPU tensors run the plain version.  CUDA tensors launch the backward
    kernels (the reverse scan in :func:`plan`'s design, then the
    deterministic dx, dW and dbias reductions over the ``[T, L, Bb, 3H]``
    and ``[T, L, Bb, H]`` scratch buffers) on the current stream, or raise:
    contiguous only; x, ys and dys all float32 or all bfloat16 (then dx is
    bfloat16 too), the rest float32.  Each call that launches adds one to
    ``fused_gru_scan_inproj_backward.launches`` (f32) or ``.launches_bf16``.
    """
    _check(x, w_ih_t, b_ih, w_hh_t, b_hh, h0)
    T, L, Bb, In = x.shape
    H = h0.shape[-1]
    G = 3 * H
    sdt, f32 = x.dtype, torch.float32
    zeros = lambda shape, dtype=f32: torch.zeros(shape, device=x.device, dtype=dtype)
    dys = zeros((T, L, Bb, H), sdt) if dys is None else dys
    dhT = zeros((L, Bb, H)) if dhT is None else dhT
    named = (("ys", ys, (T, L, Bb, H), True), ("dys", dys, (T, L, Bb, H), True),
             ("dhT", dhT, (L, Bb, H), False))
    for name, t, shape, _ in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    build.check_dtypes([(n, t, s) for n, t, _, s in named], sdt)
    dev = x.device
    if dev.type == "cpu":
        return fused_gru_scan_inproj_backward_reference(
            x, w_ih_t, b_ih, w_hh_t, b_hh, h0, ys, dys, dhT
        )
    new = lambda *shape: torch.empty(shape, device=dev, dtype=f32)
    dx = torch.empty((T, L, Bb, In), device=dev, dtype=sdt)
    dw_ih, db_ih = new(L, In, G), new(L, G)
    dw_hh, db_hh, dh0 = new(L, H, G), new(L, G), new(L, Bb, H)
    dg, dgn = new(T, L, Bb, G), new(T, L, Bb, H)
    outs = (dx, dw_ih, db_ih, dw_hh, db_hh, dh0, dg, dgn, build.dw_workspace(dev))
    p, form = plan(Bb, In, H, backward=True, L=L), build.STREAM_FORMS[sdt]
    if p.design == "wave":
        w, bias = wave_layout(w_ih_t, b_ih, w_hh_t, b_hh, p.In_p, p.Hp)
        wt = wave_transpose(w_hh_t, p.Hp)
        build.cuda_launch(
            _library(), f"se_gru_wave_bwd_{form}", (x, w, bias, wt, h0, ys, dys, dhT, w_ih_t),
            ("x", "w", "bias", "wt", "h0", "ys", "dys", "dhT", "w_ih_t"), outs,
            (T, L, Bb, In, H, *p.args(), build.DW_WORKSPACE_FLOATS), dev,
            (sdt, f32, f32, f32, f32, sdt, sdt, f32, f32))
    else:
        build.cuda_launch(
            _library(), f"se_gru_inproj_bwd_{form}",
            (x, w_ih_t, b_ih, w_hh_t, b_hh, h0, ys, dys, dhT), (*_INPUTS, "ys", "dys", "dhT"),
            outs, (T, L, Bb, In, H, *_tiling(p), build.DW_WORKSPACE_FLOATS), dev,
            (sdt,) + (f32,) * 5 + (sdt, sdt, f32))
    build.count_launch(fused_gru_scan_inproj_backward, sdt)
    return dx, dw_ih, db_ih, dw_hh, db_hh, dh0


class _FusedGruScanInproj(torch.autograd.Function):
    """The custom VJP of ``pallas_lstm.fused_gru_scan_inproj``: the forward
    keeps ``(x, w_ih_t, b_ih, w_hh_t, b_hh, h0, ys)``; the backward maps
    ``(dys, dhT)``, zeros where an output was unused, to the six input
    gradients."""

    @staticmethod
    def forward(ctx, x, w_ih_t, b_ih, w_hh_t, b_hh, h0):
        ys, hT = _forward(x, w_ih_t, b_ih, w_hh_t, b_hh, h0)
        ctx.save_for_backward(x, w_ih_t, b_ih, w_hh_t, b_hh, h0, ys)
        return ys, hT

    @staticmethod
    def backward(ctx, dys, dhT):
        cont = lambda t: None if t is None else t.contiguous()
        return fused_gru_scan_inproj_backward(*ctx.saved_tensors, cont(dys), cont(dhT))


def fused_gru_scan_inproj(x, w_ih_t, b_ih, w_hh_t, b_hh, h0):
    """Same signature and result as :func:`fused_gru_scan_inproj_reference`.

    CPU tensors run the plain version.  CUDA tensors launch the kernel in
    :func:`plan`'s design on the current stream, or raise: contiguous only,
    x float32 or bfloat16 (the bf16-stream form: ys bfloat16), the rest
    float32.  Each launch adds
    one to ``fused_gru_scan_inproj.launches`` (f32) or ``.launches_bf16``.
    When gradients are on
    and an input requires one, the call's backward is
    :func:`fused_gru_scan_inproj_backward`.
    """
    args = (x, w_ih_t, b_ih, w_hh_t, b_hh, h0)
    _check(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedGruScanInproj.apply(*args)
    return _forward(*args)


fused_gru_scan_inproj.launches = fused_gru_scan_inproj.launches_bf16 = 0
fused_gru_scan_inproj_backward.launches = fused_gru_scan_inproj_backward.launches_bf16 = 0
