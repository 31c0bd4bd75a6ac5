"""Chunked STFT analysis and synthesis with carried state (counterpart of
``se_tpu/dsp/streaming_stft.py``).

``StreamingStft`` gives the frames of :func:`stft.stft` (``torch.stft``
semantics: ``n_fft // 2`` samples of reflect padding at each end) from
waveform chunks: the left pad is taken from the first chunk, the right pad
from the carried tail at ``flush``, so the pushed frames and the flushed
ones together equal ``stft`` of the whole waveform, ``L // hop + 1``
frames.  ``StreamingIstft`` (framework STFT, FullSubNet) and
``StreamingConvIstft`` (conv-STFT, DCCRN and CRN) emit ``hop`` final
synthesis samples for every frame pushed: once frame ``t`` is added, no
later frame touches the samples below ``(t + 1) * hop``, so both the
overlap-add and the squared-window envelope there are final.  Their pushes
and ``flush`` together equal the untrimmed synthesis of :func:`stft.istft`
or :func:`stft.conv_istft`; the caller trims the edges, as the batch path
does.

State is a dict of tensors on the input's device; nothing is read back to
the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ola import overlap_add
from .stft import _centered_window


class _Windowed:
    """Holds :func:`stft.stft`'s window, moved to the stream's device once."""

    def __init__(self, n_fft: int = 512, hop: int = 300, win_len: int = 400):
        self.n_fft, self.hop = n_fft, hop
        self._window = _centered_window(win_len, n_fft, "cpu")

    def window(self, device) -> torch.Tensor:
        if self._window.device != device:
            self._window = self._window.to(device)
        return self._window


class StreamingStft(_Windowed):
    """Chunked analysis equal to :func:`stft.stft`, with carried samples."""

    def __init__(self, n_fft: int = 512, hop: int = 300, win_len: int = 400):
        super().__init__(n_fft, hop, win_len)
        self.pad = n_fft // 2

    def _emit(self, buf: torch.Tensor):
        """Every complete window in ``buf`` -> ``([B, F, m] complex frames,
        the samples left over)``."""
        n = buf.shape[-1]
        m = (n - self.n_fft) // self.hop + 1 if n >= self.n_fft else 0
        if m <= 0:
            empty = torch.zeros((buf.shape[0], self.n_fft // 2 + 1, 0), dtype=torch.complex64,
                                device=buf.device)
            return empty, buf
        frames = buf[:, : (m - 1) * self.hop + self.n_fft].unfold(-1, self.n_fft, self.hop)
        frames = frames * self.window(buf.device)
        return torch.fft.rfft(frames, n=self.n_fft).transpose(-1, -2), buf[:, m * self.hop :]

    def push(self, chunk: torch.Tensor, state: Optional[dict] = None):
        """``chunk [B, c]`` (or ``[c]``) and the state of the last push (None:
        the stream's start, where ``c`` must exceed ``n_fft // 2`` for the
        reflect pad) -> ``([B, F, k] complex frames, k possibly 0, new
        state)``."""
        if chunk.ndim == 1:
            chunk = chunk[None]
        if state is None:
            if chunk.shape[-1] <= self.pad:
                raise ValueError(
                    f"first chunk must exceed {self.pad} samples for the reflect pad "
                    "(torch.stft center=True semantics)"
                )
            left = chunk[:, 1 : self.pad + 1].flip(-1)
            buf = torch.cat([left, chunk], dim=-1)
            tail = chunk[:, -(self.pad + 1) :]
        else:
            buf = torch.cat([state["buf"], chunk], dim=-1)
            tail = torch.cat([state["tail"], chunk], dim=-1)[:, -(self.pad + 1) :]
        spec, buf = self._emit(buf)
        return spec, {"buf": buf, "tail": tail}

    def flush(self, state: dict) -> torch.Tensor:
        """End of stream: the frames over the right reflect pad."""
        right = state["tail"][:, :-1].flip(-1)
        return self._emit(torch.cat([state["buf"], right], dim=-1))[0]


def _ola_carry_push(frames, window, hop, state, normalize):
    """``frames [B, k, win]`` (windowed) overlap-added onto the carried
    ``{acc, env}`` -> ``([B, k * hop] final samples, new state)``;
    ``normalize(acc, env)`` is the path's envelope division."""
    B, k, win = frames.shape
    carry = win - hop
    out = overlap_add(frames, hop)  # [B, (k - 1) * hop + win]
    env = overlap_add((window**2)[None, None, :].expand(1, k, win), hop)
    if state is not None:
        out[:, :carry] += state["acc"]
        env[:, :carry] += state["env"]
    emit = k * hop
    return normalize(out[:, :emit], env[:, :emit]), {"acc": out[:, emit:], "env": env[:, emit:]}


def _ola_empty_push(frames, win, hop, state):
    """A push of no frames: nothing to emit; a fresh state where there was
    none."""
    B, dev = frames.shape[0], frames.device
    if state is None:
        state = {"acc": torch.zeros((B, win - hop), device=dev),
                 "env": torch.zeros((1, win - hop), device=dev)}
    return torch.zeros((B, 0), device=dev), state


class StreamingIstft(_Windowed):
    """Chunked synthesis equal to :func:`stft.istft`'s before its trim: the
    caller takes ``[n_fft // 2 : n_fft // 2 + L]`` of the concatenated
    stream, as ``istft(..., length=L)`` does."""

    @staticmethod
    def _normalize(acc, env):
        # torch.istft's least-squares envelope division, guarded near 0
        return acc / torch.where(env > 1e-11, env, torch.ones_like(env))

    def push(self, spec: torch.Tensor, state: Optional[dict] = None):
        """``spec [B, F, k]`` complex (or ``[B, F, k, 2]``) and the carried
        state (None at the start) -> ``([B, k * hop] samples, new state)``."""
        if spec.ndim == 4:
            spec = torch.complex(spec[..., 0], spec[..., 1])
        if spec.shape[-1] == 0:
            return _ola_empty_push(spec, self.n_fft, self.hop, state)
        window = self.window(spec.device)
        frames = torch.fft.irfft(spec.transpose(-1, -2), n=self.n_fft) * window
        return _ola_carry_push(frames, window, self.hop, state, self._normalize)

    def flush(self, state: dict) -> torch.Tensor:
        """The last ``n_fft - hop`` samples."""
        return self._normalize(state["acc"], state["env"])


class StreamingConvIstft:
    """Chunked synthesis of the conv-STFT path, equal to
    :func:`stft.conv_istft`'s before its trim (the pseudo-inverse basis
    ``inv [win_len, fft_len + 2]``, the overlap-add divided by the envelope
    plus 1e-8): the caller trims ``win_len - hop`` samples at each end."""

    def __init__(self, inv: torch.Tensor, window: torch.Tensor, hop: int):
        self.inv, self.window, self.hop = inv, window, hop

    @staticmethod
    def _normalize(acc, env):
        return acc / (env + 1e-8)

    def push(self, spec: torch.Tensor, state: Optional[dict] = None):
        """``spec [B, fft_len + 2, k]`` (real parts over imaginary parts) and
        the carried state -> ``([B, k * hop] samples, new state)``."""
        if spec.shape[-1] == 0:
            return _ola_empty_push(spec, self.inv.shape[0], self.hop, state)
        frames = torch.einsum("bft,nf->btn", spec, self.inv)
        return _ola_carry_push(frames, self.window, self.hop, state, self._normalize)

    def flush(self, state: dict) -> torch.Tensor:
        """The last ``win_len - hop`` samples."""
        return self._normalize(state["acc"], state["env"])
