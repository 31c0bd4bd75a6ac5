"""LSTMs and GRUs with torch weight semantics (counterpart of
``LstmParams``, ``lstm``, ``gru``, ``_scan_or_pallas`` and ``lstm_stack`` of
``se_tpu/ops/rnn.py``, f32 path).

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


def _scan(x_proj, w_hh, H, h0, c0):
    """``x_proj [T, L, B, 4H]``, ``w_hh [L, 4H, H]`` -> ``(ys [T, L, B, H], (hT, cT))``."""
    L, B = x_proj.shape[1], x_proj.shape[2]
    if h0 is None:
        h0 = x_proj.new_zeros((L, B, H))
    if c0 is None:
        c0 = x_proj.new_zeros((L, B, H))
    w_hh_t = w_hh.transpose(-1, -2).contiguous()
    return fused_lstm_scan(x_proj.contiguous(), w_hh_t, h0.contiguous(), c0.contiguous())


def lstm_stack(params: LstmParams, x, state=None):
    """L independent LSTMs in one scan.

    ``params`` carries a leading stack axis L on every field; ``x`` is
    ``[T, B, In]`` (fed to every stack) or ``[L, T, B, In]``; ``state`` is an
    optional ``(h, c)`` of ``[L, B, H]``.  Returns ``(ys [L, T, B, H],
    (hT, cT))``.
    """
    if x.dtype != torch.float32:
        raise NotImplementedError(
            "lstm_stack runs float32 only; bf16 streams come with the bf16 slice"
        )
    H = params.w_hh.shape[-1]
    eq = "tbi,lgi->tlbg" if x.ndim == 3 else "ltbi,lgi->tlbg"
    x_proj = torch.einsum(eq, x, params.w_ih)
    x_proj = x_proj + (params.b_ih + params.b_hh)[None, :, None, :]
    h0, c0 = state if state is not None else (None, None)
    ys, final = _scan(x_proj, params.w_hh, H, h0, c0)
    return ys.transpose(0, 1), final


def lstm(params: LstmParams, x, h0=None, c0=None):
    """One unidirectional LSTM layer: ``x [T, B, In]`` -> ``(ys [T, B, H],
    (hT, cT))``, ``h0``/``c0 [B, H]`` (zeros when None).  float32 only."""
    if x.dtype != torch.float32:
        raise NotImplementedError(
            "lstm runs float32 only; bf16 streams are ROADMAP.md, Queue 1 item 6"
        )
    T, B, _ = x.shape
    H = params.w_hh.shape[1]
    h0 = x.new_zeros((B, H)) if h0 is None else h0
    c0 = x.new_zeros((B, H)) if c0 is None else c0
    ys, (hT, cT) = fused_lstm_scan_inproj(
        x[:, None].contiguous(),
        params.w_ih.T[None].contiguous(),
        (params.b_ih + params.b_hh)[None],
        params.w_hh.T[None].contiguous(),
        h0[None].contiguous(),
        c0[None].contiguous(),
    )
    return ys[:, 0], (hT[0], cT[0])


def gru(params: LstmParams, x, h0=None):
    """One unidirectional GRU layer with torch gate semantics: ``x [T, B,
    In]`` -> ``(ys [T, B, H], hT [B, H])``, ``h0 [B, H]`` (zeros when None).
    float32 only."""
    if x.dtype != torch.float32:
        raise NotImplementedError(
            "gru runs float32 only; bf16 streams are ROADMAP.md, Queue 1 item 6"
        )
    T, B, _ = x.shape
    H = params.w_hh.shape[1]
    h0 = x.new_zeros((B, H)) if h0 is None else h0
    ys, hT = fused_gru_scan_inproj(
        x[:, None].contiguous(),
        params.w_ih.T[None].contiguous(),
        params.b_ih[None].contiguous(),
        params.w_hh.T[None].contiguous(),
        params.b_hh[None].contiguous(),
        h0[None].contiguous(),
    )
    return ys[:, 0], hT[0]
