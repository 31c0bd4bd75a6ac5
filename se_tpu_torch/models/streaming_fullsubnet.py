"""Chunk-streaming FullSubNet (counterpart of
``se_tpu/models/streaming_fullsubnet.py``).

FullSubNet is causal but for its ``look_ahead`` frames: its RNNs run
forward in time, the frequency unfold is per frame, and the cumulative
norms are prefix statistics.  So a stream runs whole chunks of frames at
once, carrying only the norms' running sums (``ops/norms.py``'s chunk
carries), the four RNN layers' states (the full band's at B rows, the sub
band's at B * F) and a ``look_ahead``-deep queue of noisy spectrum frames.
The mask emitted for input frame ``t`` is that of frame ``t -
look_ahead``; interior frames equal the batch forward's.  The offline
norms take utterance-wide statistics and have no causal form: a
FullSubNet with one of them does not stream.  Inference only, in f32.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..ops.cirm import decompress_cIRM
from ..ops.norms import stream_norm_wrapper
from ..ops.unfold import unfold
from .fullsubnet import FullSubNet
from .streaming import lstm_zeros


class StreamingFullSubNet(FullSubNet):
    """FullSubNet, a chunk of frames at a time; parameters as FullSubNet's."""

    def __init__(self, cfg: Config, *, generator: torch.Generator):
        if cfg.compute_dtype != "float32":
            raise ValueError("streaming runs f32 only (compute_dtype='float32'), as the JAX "
                             f"package's; got {cfg.compute_dtype!r}")
        super().__init__(cfg, generator=generator)
        self.stream_norm, self._init_carry = stream_norm_wrapper(cfg.fullsubnet.norm_type)

    def init_stream_state(self, batch: int, device=None) -> dict:
        """A fresh stream's state for ``batch`` rows on ``device`` (the
        model's by default)."""
        dev = next(self.parameters()).device if device is None else torch.device(device)
        fsn, F = self.cfg.fullsubnet, self.cfg.stft.num_freqs

        def rnn_state(rows, hidden):
            if self.cfg.sequence_model == "LSTM":
                return [lstm_zeros(dev, rows, hidden) for _ in range(2)]
            return [torch.zeros(rows, hidden, device=dev) for _ in range(2)]

        return {
            "norm_fb": self._init_carry(batch, dev),
            "norm_sb": self._init_carry(batch * F, dev),
            "fb_rnn": rnn_state(batch, fsn.fb_model_hidden_size),
            "sb_rnn": rnn_state(batch * F, fsn.sb_model_hidden_size),
            # the noisy spectrum's last look_ahead frames (real, imaginary)
            "spec_buf": torch.zeros(batch, F, fsn.look_ahead, 2, device=dev),
        }

    @torch.no_grad()
    def forward(self, noisy_mag: torch.Tensor, state: Optional[dict] = None):
        """A chunk of noisy magnitudes ``[B, F, Tc]`` and the last chunk's
        state (None: a fresh stream) -> ``([B, F, Tc, 2]`` compressed cRM,
        new state)``; the mask at chunk frame ``t`` is for the stream's
        frame ``t - look_ahead`` (a fresh stream's first ``look_ahead``
        masks stand for the batch forward's cropped warm-up)."""
        B, F, Tc = noisy_mag.shape
        if state is None:
            state = self.init_stream_state(B, noisy_mag.device)
        n_fb, n_sb = self.fb_num_neighbors * 2 + 1, self.sb_num_neighbors * 2 + 1
        x = noisy_mag[:, None]  # [B, 1, F, Tc]
        fb_in, norm_fb = self.stream_norm(x, state["norm_fb"])
        fb_out, fb_rnn = self.fb_model(fb_in.reshape(B, F, Tc), state=state["fb_rnn"],
                                       return_state=True)
        fb_unfolded = unfold(fb_out.reshape(B, 1, F, Tc), self.fb_num_neighbors)
        noisy_unfolded = unfold(x, self.sb_num_neighbors)
        sb_in = torch.cat([noisy_unfolded.reshape(B, F, n_sb, Tc),
                           fb_unfolded.reshape(B, F, n_fb, Tc)], dim=2)
        sb_in, norm_sb = self.stream_norm(sb_in, state["norm_sb"])
        sb_mask, sb_rnn = self.sb_model(sb_in.reshape(B * F, n_sb + n_fb, Tc),
                                        state=state["sb_rnn"], return_state=True)
        cRM = sb_mask.reshape(B, F, 2, Tc).permute(0, 1, 3, 2)
        return cRM, dict(state, norm_fb=norm_fb, norm_sb=norm_sb, fb_rnn=fb_rnn, sb_rnn=sb_rnn)

    @torch.no_grad()
    def enhance_chunk(self, noisy_complex: torch.Tensor, state: Optional[dict] = None):
        """A chunk of noisy spectrum frames ``[B, F, Tc]`` (complex) ->
        ``([B, F, Tc]`` enhanced frames, new state)``: each decoded mask
        times the queued frame it belongs to, so the output lags the input
        ``look_ahead`` frames (a fresh stream's first ``look_ahead`` outputs
        mask zeros)."""
        Tc = noisy_complex.shape[-1]
        cRM, state = self(noisy_complex.abs(), state)
        cRM = decompress_cIRM(cRM)
        spec = torch.stack((noisy_complex.real, noisy_complex.imag), dim=-1)
        queued = torch.cat([state["spec_buf"], spec], dim=2)
        nr, ni = queued[:, :, :Tc, 0], queued[:, :, :Tc, 1]
        er = cRM[..., 0] * nr - cRM[..., 1] * ni
        ei = cRM[..., 1] * nr + cRM[..., 0] * ni
        return torch.complex(er, ei), dict(state, spec_buf=queued[:, :, Tc:])
