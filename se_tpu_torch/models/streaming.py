"""Chunk-streaming DCCRN (counterpart of ``se_tpu/models/streaming.py``),
and the pipeline it shares with the chunk-streaming CRN
(``streaming_crn.py``).

A waveform chunk is framed on the samples carried from the last chunk,
then every stage runs over all of the chunk's frames at once; only the
recurrent bottleneck is sequential, and it runs on the hand kernels (K1
for DCCRN's complex LSTM, K2 for its real LSTM and CRN's) from the state
the last chunk left.  The carried state:

* the samples not yet framed (``win_len - hop`` once a chunk of whole hops
  has been framed; a fresh stream starts with that many zeros, the
  conv-STFT's left pad);
* one previous input frame per causal encoder conv (time kernel 2);
* the LSTMs' ``(h, c)``;
* one pending input frame per decoder stage: each transposed conv's output
  is trimmed by one frame (``[..., 1:]`` in the batch forward), so each
  stage consumes one future frame and the pipeline lags ``n_stages``
  frames (six, 37.5 ms, at hop 100 and 16 kHz);
* per decoder stage, a queue delaying the skip connection by the stage's
  lag;
* a queue of ``n_stages + 1`` spectrum frames, so that a mask multiplies
  the frame it belongs to.

Interior frames equal the batch forward's; ``flush_stream`` gives the
decoder cascade's last ``n_stages`` frames at the end of the stream, so
that chunks over ``[wav || win_len - hop zeros]`` and the flush together
equal the batch forward over the whole utterance.  The batch model packs
each stage's conv, norm and PReLU into one ``nn.Sequential``; the stream
runs the conv alone on the cached and new columns, trims them, then the
rest of the stage.  The streaming models share their batch model's
parameters and buffers, so a batch checkpoint loads with ``strict=True``.
Inference only, in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import Config
from .dccrn import DCCRN
from .layers import complex_cat


def lstm_zeros(device, *shape) -> tuple:
    """A zero LSTM state ``(h, c)`` of ``shape``."""
    return tuple(torch.zeros(shape, device=device) for _ in range(2))


class ConvRecurrentStream:
    """The chunk pipeline of DCCRN and CRN.  A subclass (also a subclass of
    the batch model) sets ``_CHANNEL_DIV`` (a stage's real channels per
    ``kernel_num`` entry: 1 for DCCRN's complex ones, which count both
    halves, 2 for CRN) and supplies ``_encoder_input``, ``_bottleneck``,
    ``_lstm_state``, ``_cat_skip`` and ``_mask_columns``."""

    _CHANNEL_DIV = 1

    def _stream_setup(self, cfg: Config):
        if cfg.compute_dtype != "float32":
            raise ValueError("streaming runs f32 only (compute_dtype='float32'), as the JAX "
                             f"package's; got {cfg.compute_dtype!r}")
        self.cfg = cfg
        self.kernel_num = (2,) + tuple(cfg.dccrn.kernel_num)

    @property
    def n_stages(self) -> int:
        return len(self.kernel_num) - 1

    def init_stream_state(self, batch: int, device=None) -> dict:
        """A fresh stream's state for ``batch`` rows, zeros on ``device``
        (the model's by default)."""
        dev = next(self.parameters()).device if device is None else torch.device(device)
        zeros = lambda *shape: torch.zeros(shape, device=dev)
        n, div, kn = self.n_stages, self._CHANNEL_DIV, self.kernel_num
        enc_freqs = [(self.fft_len // 2) // 2**i for i in range(n)]
        # decoder stage i: the previous stage's output (and encoder stage
        # n - 1 - i's, with skips), at the bottleneck's frequency times 2^i
        hidden = self.fft_len // 2 ** len(kn)
        dec_in = [kn[n - i] // div * (2 if self.skip else 1) for i in range(n)]
        win, hop = self.stft.win_len, self.stft.hop
        return {
            "tail": zeros(batch, win - hop),
            "enc_prev": [zeros(batch, kn[i] // div, enc_freqs[i], 1) for i in range(n)],
            "lstm": self._lstm_state(batch, dev),
            "dec_prev": [zeros(batch, dec_in[i], hidden * 2**i, 1) for i in range(n)],
            # stage i's skip, encoder stage n - 1 - i's output, delayed i
            # frames (stage 0's queue goes unread)
            "skip_buf": [zeros(batch, kn[n - i] // div, enc_freqs[n - 1 - i] // 2, max(i, 1))
                         for i in range(n)],
            "spec_buf": zeros(batch, self.fft_len + 2, n + 1),
        }

    @torch.no_grad()
    def forward(self, inputs: torch.Tensor, state: Optional[dict] = None):
        """A waveform chunk ``[B, c]`` and the last chunk's state (None: a
        fresh stream) -> ``([B, fft_len + 2, T] enhanced spectrum frames,
        new state)``: the chunk completes T frames, and the frames returned
        lag the input's by ``n_stages``.  A chunk that completes no frame
        is kept for the next one, and nothing else moves."""
        B = inputs.shape[0]
        if state is None:
            state = self.init_stream_state(B, inputs.device)
        win, hop = self.stft.win_len, self.stft.hop
        sig = torch.cat([state["tail"], inputs], dim=-1)
        T = (sig.shape[-1] - win) // hop + 1 if sig.shape[-1] >= win else 0
        tail = sig[:, T * hop :]
        if T == 0:
            return sig.new_zeros((B, self.fft_len + 2, 0)), dict(state, tail=tail)
        frames = sig[:, : (T - 1) * hop + win].unfold(-1, win, hop)  # [B, T, win]
        specs = torch.einsum("btn,nf->bft", frames, self.stft.weight[:, 0, :].T)

        # encoder: the cached frame, then the chunk; the conv's causal pad
        # column and the cached frame's own output are trimmed
        out, skips, enc_prev = self._encoder_input(specs), [], []
        for stage, prev in zip(self.encoder, state["enc_prev"]):
            inp = torch.cat([prev, out], dim=-1)
            enc_prev.append(out[..., -1:])
            out = stage[1:](stage[0](inp)[..., -T:])
            skips.append(out)

        cur, lstm = self._bottleneck(out, state["lstm"])

        # decoder: the pending frame, then the chunk; output columns 1..T
        n = self.n_stages
        dec_prev, skip_buf = [], [state["skip_buf"][0]]
        for i, stage in enumerate(self.decoder):
            skip = skips[n - 1 - i]
            if i:
                queued = torch.cat([state["skip_buf"][i], skip], dim=-1)
                skip = queued[..., :T]
                skip_buf.append(queued[..., -i:])
            d_in = self._cat_skip(cur, skip) if self.skip else cur
            inp = torch.cat([state["dec_prev"][i], d_in], dim=-1)
            dec_prev.append(d_in[..., -1:])
            cur = stage[1:](stage[0](inp)[..., 1 : T + 1])

        # the masks pair with the spectrum frames of n_stages frames ago
        queued = torch.cat([state["spec_buf"], specs], dim=-1)
        out_specs = self._mask_columns(cur, queued[..., 1 : T + 1])
        return out_specs, {"tail": tail, "enc_prev": enc_prev, "lstm": lstm,
                           "dec_prev": dec_prev, "skip_buf": skip_buf,
                           "spec_buf": queued[..., -(n + 1) :]}

    @torch.no_grad()
    def flush_stream(self, state: dict) -> torch.Tensor:
        """The end of the stream: the batch forward's last ``n_stages``
        frames, ``[B, fft_len + 2, n_stages]``.

        Each transposed conv's last output frame takes only its stage's
        last input frame, so the stream still owes it: stage 0 emits its
        pending column's; stage i takes the i columns flushed upstream with
        the i skip columns still queued, and emits them and its own last
        one, i + 1 columns.  The last stage's ``n_stages`` columns mask the
        most recent spectrum frames."""
        cols = None
        for i, stage in enumerate(self.decoder):
            inp = state["dec_prev"][0]
            if i:
                d_in = (self._cat_skip(cols, state["skip_buf"][i][..., :i]) if self.skip
                        else cols)
                inp = torch.cat([state["dec_prev"][i], d_in], dim=-1)
            cols = stage[1:](stage[0](inp)[..., 1:])
        return self._mask_columns(cols, state["spec_buf"][..., 1:])

    @torch.no_grad()
    def synthesize(self, out_specs: torch.Tensor) -> torch.Tensor:
        """The conv-iSTFT of collected spectrum frames, clipped to +-1."""
        return torch.clamp(self.istft(out_specs)[:, 0], -1.0, 1.0)


class StreamingDCCRN(ConvRecurrentStream, DCCRN):
    """DCCRN, a chunk at a time (E, C and R masks; complex or real LSTM;
    skips or none; BatchNorm or the complex BatchNorm)."""

    def __init__(self, cfg: Config, *, generator: torch.Generator):
        if cfg.masking_mode not in ("E", "C", "R"):
            raise ValueError(f"streaming supports E/C/R masks, got {cfg.masking_mode!r}")
        super().__init__(cfg, generator=generator)
        self._stream_setup(cfg)

    def _lstm_state(self, batch, dev):
        d = self.cfg.dccrn
        if self.real_lstm:  # two layers of (h, c) [B, H]
            return [lstm_zeros(dev, batch, d.rnn_units) for _ in range(2)]
        # each complex layer's two stacks over the doubled batch
        return [lstm_zeros(dev, 2, 2 * batch, d.rnn_units // 2) for _ in range(d.rnn_layers)]

    def _encoder_input(self, specs):
        dim = self.fft_len // 2 + 1
        return torch.stack([specs[:, :dim], specs[:, dim:]], dim=1)[:, :, 1:]

    def _bottleneck(self, out, lstm_state):
        B, C, D, T = out.shape
        seq = out.permute(3, 0, 1, 2)  # [T, B, C, D]
        if self.real_lstm:
            y, lstm = self.enhance(seq.reshape(T, B, C * D), state=lstm_state,
                                   return_state=True)
            cur = self.tranform(y).reshape(T, B, C, D)
        else:
            r = seq[:, :, : C // 2].reshape(T, B, C // 2 * D)
            i = seq[:, :, C // 2 :].reshape(T, B, C // 2 * D)
            lstm = []
            for rnn, st in zip(self.enhance, lstm_state):
                (r, i), st = rnn([r, i], state=st, return_state=True)
                lstm.append(st)
            cur = torch.cat([r.reshape(T, B, C // 2, D), i.reshape(T, B, C // 2, D)], dim=2)
        return cur.permute(1, 2, 3, 0), lstm

    def _cat_skip(self, cur, skip):
        return complex_cat([cur, skip], 1)

    def _mask_columns(self, cur, old_spec):
        dim = self.fft_len // 2 + 1
        mask_real = F.pad(cur[:, 0], (0, 0, 1, 0))  # re-pad the DC bin
        mask_imag = F.pad(cur[:, 1], (0, 0, 1, 0))
        out = self._apply_mask(mask_real, mask_imag, old_spec[:, :dim], old_spec[:, dim:])
        return torch.cat(out, dim=1)
