"""The DCCRN encoder's causal complex convolution: the hand-written CUDA
kernel ``csrc/complex_conv.cu`` (K4, forward) and its plain PyTorch version.

Counterpart of ``se_tpu/ops/pallas_conv.py``.  ``fused_complex_conv2d(x, w,
b)`` maps a doubled real|imag batch ``x [B2, C, F, T]`` through a (5, 2)
kernel ``w [Co, C, 5, 2]`` with stride (2, 1), frequency padding 2 on both
sides and causal time padding 1, plus the bias ``b [Co]``, to ``[B2, Co,
F // 2, T]``.  F must be even: for odd F the Pallas kernel gives
``F // 2`` bins where its own XLA reference gives ``(F + 1) // 2``, so the
port refuses odd F rather than pick one.

The backward is the gradient of the plain convolution (cuDNN on the card),
as the JAX package's custom VJP takes the gradient of its XLA reference
outside any Pallas kernel; there is no backward kernel.

Two forms, as the Pallas kernel has: f32, and bf16 for a bf16 ``x``.  The
weights ``w`` and ``b`` are f32 in both (the master weights); the bf16 form
casts them to bf16 itself, as ``_pallas_conv`` does (``pallas_conv.py:122-123``),
multiplies on the tensor cores, sums the products in f32, adds the bias in
f32 and rounds ``y`` to bf16 once.  That rounds once where the unfused bf16
conv (``ops/conv.py``) rounds the conv's output and then its sum with the
bias, as the reference's two paths do.  Its backward is the gradient of the
reference's bf16 conv: ``g``, ``x`` and the bf16 ``w`` in, ``dx`` in bf16,
``dw`` and ``db`` as f32 of their bf16 values.  Each form has its own C
entry and launch count (``launches``, ``launches_bf16``), and its kernel
takes ``w`` in a layout of its own, which the wrapper makes
(:func:`ffma_weights`, :func:`tensor_core_weights`, the latter as it
casts).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

KERNEL = (5, 2)
STRIDE = (2, 1)
PADDING = (2, 0)  # frequency; time is padded on the left only (causal)


def _padded(x):
    return F.pad(x, (1, 0))  # one frame of zeros before the first


def reference(x, w, b):
    """The plain version: ``F.conv2d`` of the causally padded input.  For a
    bf16 ``x``: in f32 on ``x``, ``w`` and ``b`` rounded to bf16, the result
    rounded to bf16."""
    if x.dtype == torch.bfloat16:
        bf = lambda t: t.to(torch.bfloat16).float()
        y = F.conv2d(_padded(x.float()), bf(w), bf(b), stride=STRIDE, padding=PADDING)
        return y.to(torch.bfloat16)
    return F.conv2d(_padded(x), w, b, stride=STRIDE, padding=PADDING)


CHUNK_CHANNELS = 8  # channels a chunk of the bf16 kernel: 80 rows of its K


def ffma_weights(w):
    """``w [Co, C, 5, 2]`` as the f32 kernel reads it: ``wt [10 C, Cop]``
    f32, w's rows k = (c, kf, kt) as columns (its sums still run over k in
    w's own order), each row Co channels and zeros to Cop = Co rounded up
    to 4, so that a row is whole 16-byte pieces (``csrc/complex_conv.cu``)."""
    Co = w.shape[0]
    wt = w.reshape(Co, -1).t()
    return (F.pad(wt, (0, -Co % 4)) if Co % 4 else wt).contiguous()


def tensor_core_weights(w):
    """``w [Co, C, 5, 2]`` as the bf16 kernel reads it: ``[Co, 10 Cp]``
    bf16 with Cp = C rounded up to 8, in chunks of 8 channels and 80 rows:
    row ``80 (c // 8) + 8 (2 kf + kt) + c % 8`` holds ``w[:, c, kf, kt]``,
    zero for ``c >= C``.  A chunk's rows are its channels tap by tap, so a
    tensor-core k-step of 16 rows is one kf, its two kt and 8 channels
    (``csrc/complex_conv.cu``); a row is 160 bytes a chunk."""
    Co, C = w.shape[:2]
    pad = -C % CHUNK_CHANNELS
    w = F.pad(w, (0, 0, 0, 0, 0, pad)) if pad else w
    chunked = w.reshape(Co, -1, CHUNK_CHANNELS, *KERNEL).permute(0, 1, 3, 4, 2)
    return chunked.to(torch.bfloat16, memory_format=torch.contiguous_format).view(Co, -1)


def _check(x, w, b):
    if x.ndim != 4:
        raise ValueError(f"x must be [B2, C, F, T], got {tuple(x.shape)}")
    B2, C, Fq, T = x.shape
    if w.ndim != 4 or tuple(w.shape[2:]) != KERNEL:
        raise ValueError(f"w must be [Co, C, 5, 2] (the only geometry K4 takes), "
                         f"got {tuple(w.shape)}")
    Co = w.shape[0]
    if w.shape[1] != C or tuple(b.shape) != (Co,):
        raise ValueError(f"w {tuple(w.shape)} and b {tuple(b.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if Fq % 2:
        raise ValueError(f"F must be even, got {Fq}: for odd F the reference's "
                         "kernel and its XLA conv disagree on the bin count")
    named = (("x", x), ("w", w), ("b", b))
    build.check_dtypes([(name, t, name == "x") for name, t in named], x.dtype)
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _library():
    lib = build.load("complex_conv")
    if lib.se_complex_conv_fwd_f32.argtypes is None:
        for form in build.STREAM_FORMS.values():
            fn = getattr(lib, f"se_complex_conv_fwd_{form}")
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _forward(x, w, b):
    """The plain version for CPU tensors; K4 for CUDA tensors (counted on
    ``fused_complex_conv2d``), with ``w`` in the kernel's layout and ``b``
    cast to x's dtype."""
    if x.device.type == "cpu":
        return reference(x, w, b)
    B2, C, Fq, T = x.shape
    Co = w.shape[0]
    dt = x.dtype
    y = torch.empty((B2, Co, Fq // 2, T), device=x.device, dtype=dt)
    build.cuda_launch(_library(), f"se_complex_conv_fwd_{build.STREAM_FORMS[dt]}",
                      (x, tensor_core_weights(w) if dt == torch.bfloat16 else ffma_weights(w),
                       b.to(dt)),
                      ("x", "w", "b"), (y,), (B2, C, Fq, T, Co),
                      x.device, (dt,) * 3)
    build.count_launch(fused_complex_conv2d, dt)
    return y


class _FusedComplexConv2d(torch.autograd.Function):
    """The custom VJP of ``pallas_conv.fused_complex_conv2d``: the forward
    keeps ``(x, w, b)``; the backward is the plain convolution's gradient,
    without running its forward again: in x's dtype, the weights cast to it
    and their gradients returned as f32."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return _forward(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        dxp, dw, db = torch.ops.aten.convolution_backward(
            g.contiguous(), _padded(x), w.to(x.dtype), [b.shape[0]], list(STRIDE),
            list(PADDING), [1, 1], False, [0, 0], 1, list(ctx.needs_input_grad),
        )
        f32 = lambda t: None if t is None else t.float()
        return (None if dxp is None else dxp[..., 1:]), f32(dw), f32(db)


def fused_complex_conv2d(x, w, b):
    """Same signature and result as :func:`reference`, for even F and the
    (5, 2) kernel only (raises otherwise).

    CPU tensors run the plain version.  CUDA tensors launch K4 on the
    current stream, or raise: contiguous only, x float32 or bfloat16 (then
    y is bfloat16), w and b float32.  Each launch adds one to
    ``fused_complex_conv2d.launches`` (f32) or ``.launches_bf16``.
    Gradients go through the plain convolution's backward.
    """
    _check(x, w, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        return _FusedComplexConv2d.apply(x, w, b)
    return _forward(x, w, b)


fused_complex_conv2d.launches = fused_complex_conv2d.launches_bf16 = 0
