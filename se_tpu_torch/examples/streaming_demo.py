"""Streaming enhancement demo (counterpart of ``examples/streaming_demo.py``):
a narrow DCCRN over chunked audio with its state carried from chunk to
chunk.

Each chunk of whole hops goes through ``StreamingDCCRN`` (the batch model's
weights, every stage over the chunk's frames at once, the LSTM from the
last chunk's state) and its enhanced frames through ``StreamingConvIstft``,
which emits the samples no later frame can change.  Interior frames equal
the batch forward's; the frames lag the input by ``n_stages`` frames.

    python -m se_tpu_torch.examples.streaming_demo               # on the card
    python -m se_tpu_torch.examples.streaming_demo --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import Config, DccrnConfig
from ..dsp.streaming_stft import StreamingConvIstft
from ..enhance import chunk_samples
from ..models.factory import build_stream_model


def main(argv=None) -> int:
    """Stream synthetic noisy audio -> the number of samples emitted."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seconds", type=float, default=2.0, help="length of the audio")
    p.add_argument("--chunk-ms", type=int, default=100,
                   help="chunk length, rounded down to whole STFT hops")
    args = p.parse_args(argv)

    cfg = Config(dccrn=DccrnConfig(kernel_num=(8, 16, 16, 32, 32, 32), rnn_units=32))
    stream = build_stream_model(cfg, device=args.device)
    dev = next(stream.parameters()).device
    s = cfg.stft

    rng = np.random.default_rng(0)
    t = np.arange(int(round(args.seconds * s.fs))) / s.fs
    clean = 0.3 * np.sin(2 * np.pi * 440 * t) * np.clip(np.sin(2 * np.pi * 3 * t), 0, None)
    noisy = torch.from_numpy((clean + 0.05 * rng.standard_normal(len(t))).astype(np.float32))

    # chunks in, final samples out after each (streaming synthesis, no
    # end-of-utterance pass)
    syn = StreamingConvIstft(stream.istft.weight[:, 0, :].T, stream.istft.window[0, :, 0],
                             s.win_inc)
    chunk = chunk_samples(cfg, args.chunk_ms)
    state = sstate = None
    n_chunks = n_samples = 0
    for start in range(0, len(noisy), chunk):
        seg = noisy[None, start : start + chunk].to(dev)
        spec, state = stream(seg, state)
        samples, sstate = syn.push(spec, sstate)
        samples = samples.clamp(-1.0, 1.0)
        n_chunks += 1
        n_samples += samples.shape[-1]
        print(f"chunk @{start / s.fs:.2f}s -> {spec.shape[-1]} frames, "
              f"{samples.shape[-1]} samples out")
    n_samples += syn.flush(sstate).shape[-1]
    lag_ms = 1000 * stream.n_stages * s.win_inc / s.fs
    print(f"streamed {n_chunks} chunks -> {n_samples} samples ({lag_ms:g} ms model latency "
          f"+ one-frame OLA latency)")
    return n_samples


if __name__ == "__main__":
    main()
