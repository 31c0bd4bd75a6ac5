"""Fused LSTM-stack scan: the hand-written CUDA kernel
``csrc/lstm_scan.cu`` and its plain PyTorch version.

Counterpart of ``fused_lstm_scan`` in ``se_tpu/ops/pallas_lstm.py``
(forward only; the backward kernel comes with the training path).  The
kernel's design and what bounds it are described at the top of its source.
"""

from __future__ import annotations

import ctypes

import torch

from . import build


def fused_lstm_scan_reference(x_proj, w_hh_t, h0, c0):
    """The plain recurrence: ``x_proj [T, L, Bb, 4H]`` (biases folded in),
    ``w_hh_t [L, H, 4H]``, ``h0``/``c0 [L, Bb, H]`` ->
    ``(ys [T, L, Bb, H] in x_proj's dtype, (hT, cT) f32)``.

    Gate order i, f, g, o; the carry and the gate math are f32.
    """
    H = h0.shape[-1]
    h, c = h0.float(), c0.float()
    w = w_hh_t.float()
    ys = []
    for t in range(x_proj.shape[0]):
        gates = x_proj[t].float() + torch.bmm(h, w)
        i = torch.sigmoid(gates[..., 0 * H : 1 * H])
        f = torch.sigmoid(gates[..., 1 * H : 2 * H])
        g = torch.tanh(gates[..., 2 * H : 3 * H])
        o = torch.sigmoid(gates[..., 3 * H : 4 * H])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h.to(x_proj.dtype))
    return torch.stack(ys), (h, c)


def _check(x_proj, w_hh_t, h0, c0):
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
    for name, t in (("x_proj", x_proj), ("w_hh_t", w_hh_t), ("h0", h0), ("c0", c0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x_proj.device:
            raise ValueError(f"{name} is on {t.device}, x_proj on {x_proj.device}")


def _library():
    """The built kernel library, with its C signatures declared."""
    lib = build.load("lstm_scan")
    if lib.se_lstm_scan_fwd_f32.argtypes is None:
        lib.se_lstm_scan_fwd_f32.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        lib.se_lstm_scan_fwd_f32.restype = ctypes.c_int
        lib.se_cuda_error_string.argtypes = [ctypes.c_int]
        lib.se_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_lstm_scan(x_proj, w_hh_t, h0, c0):
    """Same signature and result as :func:`fused_lstm_scan_reference`.

    CPU tensors run the plain version.  CUDA tensors launch the kernel on
    the current stream, or raise: float32 only, contiguous, and no
    gradient (the backward kernel is not ported yet).  Each launch adds
    one to ``fused_lstm_scan.launches``.
    """
    _check(x_proj, w_hh_t, h0, c0)
    dev = x_proj.device
    if dev.type == "cpu":
        return fused_lstm_scan_reference(x_proj, w_hh_t, h0, c0)
    if dev.type != "cuda":
        raise ValueError(f"fused_lstm_scan runs on cuda or cpu, not {dev}")
    tensors = (x_proj, w_hh_t, h0, c0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "fused_lstm_scan has no backward kernel yet; call it under "
            "torch.no_grad() or torch.inference_mode()"
        )
    for name, t in zip(("x_proj", "w_hh_t", "h0", "c0"), tensors):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    T, L, Bb, G = x_proj.shape
    H = G // 4
    ys = torch.empty((T, L, Bb, H), device=dev, dtype=torch.float32)
    hT = torch.empty((L, Bb, H), device=dev, dtype=torch.float32)
    cT = torch.empty((L, Bb, H), device=dev, dtype=torch.float32)
    lib = _library()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    rc = lib.se_lstm_scan_fwd_f32(
        x_proj.data_ptr(), w_hh_t.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        ys.data_ptr(), hT.data_ptr(), cT.data_ptr(),
        T, L, Bb, H, index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc:
        msg = lib.se_cuda_error_string(rc).decode()
        raise RuntimeError(f"lstm_scan kernel launch failed: CUDA error {rc} ({msg})")
    fused_lstm_scan.launches += 1
    return ys, (hT, cT)


fused_lstm_scan.launches = 0
