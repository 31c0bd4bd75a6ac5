"""Chunk-streaming CRN (counterpart of ``se_tpu/models/streaming_crn.py``):
the pipeline of ``streaming.py`` on CRN's real-valued network, its one
LSTM layer on K2 from the carried state, and a tanh mask on the queued
noisy magnitude with the queued noisy phase."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import Config
from ..ops.magnitude import complex_mag
from .crn import CRN
from .streaming import ConvRecurrentStream, lstm_zeros


class StreamingCRN(ConvRecurrentStream, CRN):
    """CRN, a chunk at a time (skips or none); parameters and buffers as
    CRN's."""

    _CHANNEL_DIV = 2  # a stage's real channels are half its kernel_num entry

    def __init__(self, cfg: Config, *, generator: torch.Generator):
        super().__init__(cfg, generator=generator)
        self._stream_setup(cfg)

    def _lstm_state(self, batch, dev):
        return [lstm_zeros(dev, batch, self.cfg.crn.rnn_units // 2)]

    def _encoder_input(self, specs):
        dim = self.fft_len // 2 + 1
        return complex_mag(specs[:, :dim], specs[:, dim:])[:, None, 1:]  # drop the DC bin

    def _bottleneck(self, out, lstm_state):
        B, C, D, T = out.shape
        seq = out.permute(3, 0, 1, 2).reshape(T, B, C * D)
        y, lstm = self.enhance(seq, state=lstm_state, return_state=True)
        return self.tranform(y).reshape(T, B, C, D).permute(1, 2, 3, 0), lstm

    def _cat_skip(self, cur, skip):
        return torch.cat([cur, skip], 1)

    def _mask_columns(self, cur, old_spec):
        """The batch forward's output spectrum on the queued frames: the
        tanh mask (or, in direct mode, the magnitude itself) with the noisy
        phase."""
        dim = self.fft_len // 2 + 1
        real, imag = old_spec[:, :dim], old_spec[:, dim:]
        mags, phase = complex_mag(real, imag), torch.atan2(imag, real)
        out = F.pad(cur[:, 0], (0, 0, 1, 0))  # re-pad the DC bin
        est_mags = out if self.direct else torch.tanh(out) * mags
        return torch.cat([est_mags * torch.cos(phase), est_mags * torch.sin(phase)], dim=1)
