"""LSTMs and GRUs with torch weight semantics (counterpart of
``LstmParams``, ``lstm``, ``gru``, ``_scan_or_pallas`` and ``lstm_stack`` of
``se_tpu/ops/rnn.py`` with its Pallas branches).

``lstm_stack`` (the complex LSTM's stacks): the input projection of all
time steps is one product outside the recurrence; the recurrence itself
goes to the fused scan of ``fused_lstm.py``, which launches the CUDA kernel
for CUDA tensors and runs the plain loop (the JAX package's ``_lstm_scan``)
for CPU tensors.  Gradients reach ``w_hh`` and the initial state through
the scan's backward (the K1b kernel on the card) and ``w_ih``, the biases
and the input through torch's autograd of the product and the bias add,
which the JAX package also leaves outside its kernel.

``lstm`` (one layer of ``nn.LSTM``): the whole layer, projection included,
goes to ``fused_lstm_inproj.py`` (the K2 kernels on the card), as the JAX
package's Pallas branch hands it to ``fused_lstm_scan_inproj``.

``gru`` (one layer of ``nn.GRU``): the whole layer goes to
``fused_gru_inproj.py`` (the K3 kernels on the card), as the Pallas branch
hands it to ``fused_gru_scan_inproj``; the two biases stay separate.

bf16 inputs get the reference's mixed semantics: bf16 streams around an
f32 ``(h, c)`` carry and f32 gate math, the weights kept f32.
``lstm_stack`` projects in bf16 (``x`` and ``w_ih`` cast, the bf16 bias
sum added) and runs the scan's bf16-stream form; ``lstm`` and ``gru`` hand
the bf16 ``x`` to their in-projection scan's bf16-stream form, which
projects it in f32, as the reference's Pallas branch does (its scan branch
projects in bf16; the two differ by bf16 rounding).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .fused_gru_inproj import fused_gru_scan_inproj
from .fused_lstm import fused_lstm_scan
from .fused_lstm_inproj import fused_lstm_scan_inproj


class LstmParams(NamedTuple):
    """One layer's weights; G = 4H for an LSTM, 3H for a GRU."""

    w_ih: torch.Tensor  # [G, In]  (a leading stack axis L in lstm_stack)
    w_hh: torch.Tensor  # [G, H]
    b_ih: torch.Tensor  # [G]
    b_hh: torch.Tensor  # [G]


def _f32_state(s, shape, like):
    """An initial state as float32: zeros of ``shape`` on ``like``'s device
    when None."""
    if s is None:
        return torch.zeros(shape, dtype=torch.float32, device=like.device)
    return s.to(torch.float32).contiguous()


def _scan(x_proj, w_hh, H, h0, c0):
    """``x_proj [T, L, B, 4H]`` (f32 or bf16), ``w_hh [L, 4H, H]`` ->
    ``(ys [T, L, B, H] in x_proj's dtype, (hT, cT) f32)``."""
    L, B = x_proj.shape[1], x_proj.shape[2]
    h0 = _f32_state(h0, (L, B, H), x_proj)
    c0 = _f32_state(c0, (L, B, H), x_proj)
    w_hh_t = w_hh.to(torch.float32).transpose(-1, -2).contiguous()
    return fused_lstm_scan(x_proj.contiguous(), w_hh_t, h0, c0)


def lstm_stack(params: LstmParams, x, state=None):
    """L independent LSTMs in one scan.

    ``params`` carries a leading stack axis L on every field; ``x`` is
    ``[T, B, In]`` (fed to every stack) or ``[L, T, B, In]``; ``state`` is an
    optional ``(h, c)`` of ``[L, B, H]``.  Returns ``(ys [L, T, B, H] in
    x's dtype, (hT, cT) f32)``.  A bf16 ``x`` takes the mixed form of the
    reference (``se_tpu/ops/rnn.py:334-355``): the projection in bf16, then
    the scan's bf16-stream form.
    """
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lstm_stack takes float32 or bfloat16 inputs, got {x.dtype}")
    H = params.w_hh.shape[-1]
    eq = "tbi,lgi->tlbg" if x.ndim == 3 else "ltbi,lgi->tlbg"
    x_proj = torch.einsum(eq, x, params.w_ih.to(x.dtype))
    x_proj = x_proj + (params.b_ih + params.b_hh).to(x.dtype)[None, :, None, :]
    h0, c0 = state if state is not None else (None, None)
    ys, final = _scan(x_proj, params.w_hh, H, h0, c0)
    return ys.transpose(0, 1), final


def lstm(params: LstmParams, x, h0=None, c0=None):
    """One unidirectional LSTM layer: ``x [T, B, In]`` (f32 or bf16) ->
    ``(ys [T, B, H] in x's dtype, (hT, cT) f32)``, ``h0``/``c0 [B, H]``
    (zeros when None; taken as f32).  The weights go to the kernel as f32
    whatever x's dtype, as the reference's Pallas branch casts them
    (``se_tpu/ops/rnn.py:140-145``)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lstm takes float32 or bfloat16 inputs, got {x.dtype}")
    T, B, _ = x.shape
    H = params.w_hh.shape[1]
    h0 = _f32_state(h0, (B, H), x)
    c0 = _f32_state(c0, (B, H), x)
    f32 = torch.float32
    ys, (hT, cT) = fused_lstm_scan_inproj(
        x[:, None].contiguous(),
        params.w_ih.to(f32).T[None].contiguous(),
        (params.b_ih + params.b_hh).to(f32)[None],
        params.w_hh.to(f32).T[None].contiguous(),
        h0[None],
        c0[None],
    )
    return ys[:, 0], (hT[0], cT[0])


def gru(params: LstmParams, x, h0=None):
    """One unidirectional GRU layer with torch gate semantics: ``x [T, B,
    In]`` (f32 or bf16) -> ``(ys [T, B, H] in x's dtype, hT [B, H] f32)``,
    ``h0 [B, H]`` (zeros when None; taken as f32).  The weights go to the
    kernel as f32 whatever x's dtype, as the reference's Pallas branch casts
    them (``se_tpu/ops/rnn.py:408-428``)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gru takes float32 or bfloat16 inputs, got {x.dtype}")
    T, B, _ = x.shape
    H = params.w_hh.shape[1]
    h0 = _f32_state(h0, (B, H), x)
    f32 = torch.float32
    ys, hT = fused_gru_scan_inproj(
        x[:, None].contiguous(),
        params.w_ih.to(f32).T[None].contiguous(),
        params.b_ih.to(f32)[None].contiguous(),
        params.w_hh.to(f32).T[None].contiguous(),
        params.b_hh.to(f32)[None].contiguous(),
        h0[None],
    )
    return ys[:, 0], hT[0]
