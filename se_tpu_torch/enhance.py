"""Enhancement with a DCCRN, CRN or FullSubNet checkpoint, in batches or
streaming (counterpart of the repository's ``enhance.py``).

    python -m se_tpu_torch.enhance --checkpoint chkpt.pt --model DCCRN \\
        [--lstm complex] [--masking-mode E] [--batch N] [--device cuda] \\
        noisy1.wav ... --out-dir DIR
    python -m se_tpu_torch.enhance --checkpoint chkpt.pt --model CRN noisy.wav
    python -m se_tpu_torch.enhance --checkpoint chkpt.pt --model DCCRN \
        --use-cbn --no-skip noisy.wav
    python -m se_tpu_torch.enhance --checkpoint chkpt.pt --model FullSubNet \\
        [--sequence-model GRU] [--fsn-norm cumulative_laplace_norm] noisy.wav
    python -m se_tpu_torch.enhance --checkpoint chkpt.pt --model CRN \\
        --compute-dtype bfloat16 noisy.wav
    python -m se_tpu_torch.enhance --checkpoint chkpt.pt --model FullSubNet \\
        [--sequence-model GRU] --compute-dtype bfloat16 noisy.wav
    python -m se_tpu_torch.enhance --checkpoint chkpt.pt --model DCCRN \\
        --streaming [--chunk-ms 100] noisy.wav
    python -m se_tpu_torch.enhance --checkpoint chkpt.pt --model FullSubNet \\
        --fsn-norm cumulative_laplace_norm --streaming noisy.wav

The checkpoint is the reference's ``{'model', 'optimizer', 'epoch'}``
blob, as ``python -m se_tpu.utils.torch_export`` writes it.  Runs on the
card unless ``--device cpu`` is given.  Files are zero-padded to whole
seconds before the forward and trimmed after it, as the JAX CLI's
bucketed path does; files no longer than one analysis window (FullSubNet:
``fft_len // 2`` samples, its framing's reflect padding) run at their
exact length.  FullSubNet with an offline norm buckets as the JAX CLI
does: the buffer is ``ceil((L + fft_len / 2) / fs) * fs`` samples, its
first ``fft_len / 2`` pad samples reflect the signal's tail, and the model
gets ``valid_frames = 1 + L // torch_hop``, so the output matches the
exact-length run.  ``--batch N`` stacks files of the same one-second bucket
into batches of N rows, padding the last batch of a bucket by repeating
its last row; rows are independent, so each output matches its
``--batch 1`` run up to float rounding.  ``--compute-dtype bfloat16`` runs
DCCRN, CRN and FullSubNet in the reference's mixed precision
(``Config.compute_dtype``); FullSubNet's bucketing is the same in bf16.
``--no-skip`` and ``--use-cbn`` name a checkpoint trained without skip
connections or with DCCRN's complex BatchNorm.

``--streaming`` runs each file through the chunk-streaming model
(``models/streaming*.py``) in pieces of ``--chunk-ms`` (rounded down to
whole STFT hops, at least one), carrying its state on the device from
chunk to chunk, with a fixed algorithmic latency: ``n_stages`` frames for
DCCRN and CRN (37.5 ms at hop 100 and 16 kHz), ``look_ahead`` frames for
FullSubNet (37.5 ms at hop 300).
DCCRN and CRN push the file, then the conv-STFT's ``win_len - hop`` zeros,
then flush the decoder; FullSubNet pushes the file (padded to ``fft_len /
2 + 1`` samples if shorter) and, after the analysis' flush, its
``look_ahead`` zero frames.  The output equals the batch forward over the
whole file at its exact length.  Streaming runs f32 only, one file at a
time (``--batch 1``), and FullSubNet streams only with a cumulative norm
(``--fsn-norm cumulative_laplace_norm`` or ``cumulative_layer_norm``).  A DCCRN trained with
``--masking-mode 'Direct(None make)'`` cannot enhance without targets, as
in the JAX CLI: its forward raises ``ValueError``.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np
import torch

from .config import Config, DccrnConfig, FullSubNetConfig
from .data.wav import read_wav, write_wav
from .device import resolve_device
from .dsp.stft import stft
from .dsp.streaming_stft import StreamingConvIstft, StreamingIstft, StreamingStft
from .models.factory import build_model, build_stream_model
from .models.fullsubnet import FullSubNet
from .models.streaming_fullsubnet import StreamingFullSubNet
from .train.steps import fullsubnet_enhance
from .utils.weights import load_reference_checkpoint


def enhance_batch(model: torch.nn.Module, wavs, device="cuda", valid_frames=None) -> torch.Tensor:
    """Enhance ``wavs [B, L]`` with ``model`` on ``device`` -> ``[B, L']``.
    DCCRN and CRN: ``L' = L`` when L is a multiple of the STFT hop (else the
    last partial hop is dropped, as in the reference).  FullSubNet: framework
    STFT, the model's cRM, its decode and the iSTFT at length L;
    ``valid_frames`` (one count per row, or one for all) marks the frames
    of a padded buffer that are real (see ``FullSubNet.forward``)."""
    dev = resolve_device(device)
    model.to(dev).eval()
    with torch.inference_mode():
        x = torch.as_tensor(wavs, dtype=torch.float32).to(dev)
        if x.ndim != 2:
            raise ValueError(f"wavs must be [B, L], got {tuple(x.shape)}")
        if isinstance(model, FullSubNet):
            s = model.cfg.stft
            noisy_complex = stft(x, s.fft_len, s.torch_hop, s.win_len)
            cRM = model(noisy_complex.abs(), valid_frames=valid_frames)
            return fullsubnet_enhance(model.cfg, cRM, noisy_complex, x.shape[-1])
        if valid_frames is not None:
            raise ValueError("valid_frames is FullSubNet's; DCCRN and CRN take none")
        return model(x)[-1]


def _conv_stream(model, chunks):
    """DCCRN and CRN: each chunk through the model, its enhanced frames
    (after the ``n_stages`` warm-up frames) through the conv-iSTFT's
    overlap-add; at the end the conv-STFT's ``win_len - hop`` zeros, the
    decoder's flush and the overlap-add's last samples."""
    win, hop = model.stft.win_len, model.stft.hop
    syn = StreamingConvIstft(model.istft.weight[:, 0, :].T, model.istft.window[0, :, 0], hop)
    state = sstate = None
    skip = model.n_stages

    def emit(spec):
        nonlocal skip, sstate
        drop = min(skip, spec.shape[-1])
        skip -= drop
        y, sstate = syn.push(spec[..., drop:], sstate)
        return y.clamp(-1.0, 1.0)  # pointwise: the batch forward's clip

    for chunk in chunks:
        spec, state = model(chunk, state)
        yield emit(spec)
    pad = chunk.new_zeros((chunk.shape[0], win - hop))
    spec, state = model(pad, state)
    yield emit(spec)
    yield emit(model.flush_stream(state))
    yield syn.flush(sstate).clamp(-1.0, 1.0)


def _spectrum_stream(model, chunks):
    """FullSubNet: each chunk through the framework STFT's analysis, its
    frames through ``enhance_chunk`` (after the ``look_ahead`` warm-up
    frames) and the iSTFT's overlap-add; at the end the analysis' flush with
    the batch forward's ``look_ahead`` zero frames, and the overlap-add's
    last samples."""
    s = model.cfg.stft
    ana = StreamingStft(s.fft_len, s.torch_hop, s.win_len)
    syn = StreamingIstft(s.fft_len, s.torch_hop, s.win_len)
    ast = mst = sstate = None
    skip = model.look_ahead

    def emit(frames):
        nonlocal mst, sstate, skip
        if frames.shape[-1] == 0:
            return frames.real.new_zeros((frames.shape[0], 0))
        enhanced, mst = model.enhance_chunk(frames, mst)
        drop = min(skip, enhanced.shape[-1])
        skip -= drop
        y, sstate = syn.push(enhanced[..., drop:], sstate)
        return y

    for chunk in chunks:
        frames, ast = ana.push(chunk, ast)
        yield emit(frames)
    frames = ana.flush(ast)
    look_ahead = frames.new_zeros((*frames.shape[:2], model.look_ahead))
    yield emit(torch.cat([frames, look_ahead], dim=-1))
    yield syn.flush(sstate)


def stream_chunks(model, chunks):
    """Enhance a stream with a chunk-streaming model (``build_stream_model``;
    its calls take no gradient): ``chunks`` is an iterable of waveform
    pieces ``[B, c]`` on the model's device; yields the final enhanced
    samples ``[B, n]`` ready after each piece, then, after the last, those
    of the end of the stream.  Concatenated, they are the synthesis before
    the batch path's edge trim (:func:`stream_output` takes it).  FullSubNet's
    first piece must exceed ``fft_len / 2`` samples (its reflect pad)."""
    stream = _spectrum_stream if isinstance(model, StreamingFullSubNet) else _conv_stream
    return stream(model, chunks)


def stream_output(model, y: torch.Tensor, length: int) -> torch.Tensor:
    """The concatenated samples of :func:`stream_chunks` ``[B, n]`` -> the
    batch forward's output for ``length`` input samples, ``[B, length]``:
    the edge trim of the conv-iSTFT (``win_len - hop`` at each end) or of
    the iSTFT (``fft_len / 2`` at the start), zeros past the synthesis."""
    if isinstance(model, StreamingFullSubNet):
        pad = model.cfg.stft.fft_len // 2
        y = y[..., pad : pad + length]
    else:
        trim = model.stft.win_len - model.stft.hop
        y = y[..., trim : y.shape[-1] - trim][..., :length]
    return torch.nn.functional.pad(y, (0, length - y.shape[-1]))


def chunk_samples(cfg: Config, chunk_ms: int) -> int:
    """``chunk_ms`` in samples, rounded down to whole hops of the model's
    STFT (FullSubNet's framework STFT, or the conv-STFT), at least one."""
    hop = cfg.stft.torch_hop if cfg.model == "FullSubNet" else cfg.stft.win_inc
    return max(1, chunk_ms * cfg.stft.fs // 1000 // hop) * hop


def enhance_stream(model, wav, chunk: int, device="cuda") -> torch.Tensor:
    """One file ``wav [L]`` through a chunk-streaming model in pieces of
    ``chunk`` samples -> the enhanced ``[L]`` on ``device``: the batch
    forward's output at the exact length.  A FullSubNet file shorter than
    ``fft_len / 2 + 1`` samples is zero-padded to that first (its cumulative
    norms and RNNs are causal, so the pad leaves the kept samples alone)."""
    dev = resolve_device(device)
    x = torch.as_tensor(wav, dtype=torch.float32).to(dev)[None]
    L = x.shape[-1]
    if isinstance(model, StreamingFullSubNet):
        x = torch.nn.functional.pad(x, (0, max(0, model.cfg.stft.fft_len // 2 + 1 - L)))
    y = torch.cat(list(stream_chunks(model, x.split(chunk, dim=-1))), dim=-1)
    return stream_output(model, y, L)[0]


def short_file_limit(cfg: Config) -> int:
    """Files of at most this many samples run at their exact length: one
    analysis window, or for FullSubNet its framing's ``fft_len // 2``
    samples of reflect padding, which no padded buffer reproduces."""
    return cfg.stft.fft_len // 2 if cfg.model == "FullSubNet" else cfg.stft.win_len


def _offline_norm(cfg: Config) -> bool:
    return cfg.model == "FullSubNet" and cfg.fullsubnet.norm_type.startswith("offline")


def bucket_length(cfg: Config, L: int) -> int:
    """The buffer a file of ``L`` samples runs in: whole seconds, with
    ``fft_len // 2`` samples of room for the reflected tail when FullSubNet
    takes an offline norm (an utterance-global statistic)."""
    fs = cfg.stft.fs
    return -(-(L + (cfg.stft.fft_len // 2) * _offline_norm(cfg)) // fs) * fs


def bucket_buffer(cfg: Config, wav: np.ndarray, length: int):
    """``wav`` in a buffer of ``length`` samples -> ``(buffer, valid frames
    or None)``: zero padding, except for FullSubNet with an offline norm,
    whose first ``fft_len // 2`` pad samples reflect the tail (``x[L+k] =
    x[L-2-k]``, what the framing's reflect padding reads past the end) and
    whose model masks the frames from ``1 + L // torch_hop`` on."""
    L = len(wav)
    if not _offline_norm(cfg) or length == L:
        return np.pad(wav, (0, length - L)), None
    margin = cfg.stft.fft_len // 2
    buf = np.zeros(length, np.float32)
    buf[:L] = wav
    tail = wav[max(L - 1 - margin, 0) : max(L - 1, 0)][::-1]
    buf[L : L + len(tail)] = tail
    return buf, 1 + L // cfg.stft.torch_hop


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("wavs", nargs="+")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--model", default="DCCRN", choices=["DCCRN", "CRN", "FullSubNet"])
    p.add_argument("--masking-mode", default="E")
    p.add_argument("--lstm", default="complex", choices=["complex", "real"])
    p.add_argument("--sequence-model", default="LSTM", choices=["LSTM", "GRU"],
                   help="FullSubNet's RNN, as the checkpoint was trained")
    p.add_argument("--fsn-norm", default=None,
                   help="FullSubNet norm_type override (the norms hold no parameters)")
    p.add_argument("--no-skip", action="store_true",
                   help="checkpoint was trained with skip_type=False")
    p.add_argument("--use-cbn", action="store_true",
                   help="checkpoint was trained with complex batch norm")
    p.add_argument("--out-dir", default="enhanced")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--streaming", action="store_true",
                   help="chunked carried-state inference with a fixed algorithmic latency, "
                   "equal to the whole-file forward (FullSubNet needs --fsn-norm "
                   "cumulative_*)")
    p.add_argument("--chunk-ms", type=int, default=100,
                   help="--streaming's chunk, rounded down to whole STFT hops")
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="activation dtype of the batch forward (--streaming runs f32)")
    args = p.parse_args(argv)
    if args.batch < 1:
        p.error(f"--batch must be >= 1 (got {args.batch})")
    if args.streaming and args.batch > 1:
        p.error("--batch needs the bucketed batch path: drop --streaming")
    if args.streaming and args.compute_dtype != "float32":
        raise SystemExit("--streaming runs f32 only (sample-exact vs the f32 batch forward)")
    if (args.streaming and args.model == "FullSubNet"
            and not (args.fsn_norm or "").startswith("cumulative")):
        raise SystemExit(
            "FullSubNet streaming needs a causal norm: pass --fsn-norm "
            "cumulative_laplace_norm (or cumulative_layer_norm).  The offline_* norms are "
            "utterance-global statistics with no causal form."
        )
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        p.error(str(e))

    fsn = FullSubNetConfig(norm_type=args.fsn_norm) if args.fsn_norm else FullSubNetConfig()
    cfg = Config(model=args.model, masking_mode=args.masking_mode, lstm=args.lstm,
                 sequence_model=args.sequence_model, skip_type=not args.no_skip,
                 dccrn=DccrnConfig(use_cbn=args.use_cbn), fullsubnet=fsn,
                 compute_dtype=args.compute_dtype)
    model = (build_stream_model if args.streaming else build_model)(cfg, device=dev)
    model.load_state_dict(load_reference_checkpoint(args.checkpoint)[0], strict=True)
    os.makedirs(args.out_dir, exist_ok=True)
    fs = cfg.stft.fs
    short_limit = short_file_limit(cfg)

    def run(rows, length: int) -> np.ndarray:
        prepped = [bucket_buffer(cfg, w, length) for w in rows]
        buf = np.stack([b for b, _ in prepped])
        vf = None if prepped[0][1] is None else np.array([n for _, n in prepped])
        return enhance_batch(model, buf, dev, valid_frames=vf).cpu().numpy()

    def read(path) -> np.ndarray:
        return read_wav(path, fs)[0].astype(np.float32)

    def write_out(path, y):
        out_path = os.path.join(args.out_dir, os.path.basename(path))
        write_wav(out_path, y, fs)
        print(f"enhanced {path} -> {out_path}")

    if args.streaming:
        chunk = chunk_samples(cfg, args.chunk_ms)
        for path in args.wavs:
            write_out(path, enhance_stream(model, read(path), chunk, dev).cpu().numpy())
        return

    if args.batch == 1:
        for path in args.wavs:
            wav = read(path)
            L = len(wav)
            length = L if L <= short_limit else bucket_length(cfg, L)
            write_out(path, run([wav], length)[0][:L])
        return

    # two passes keep host memory O(batch): lengths first, then one
    # group's files at a time
    groups = defaultdict(list)  # padded length -> [(path, L)]
    for path in args.wavs:
        wav = read(path)
        L = len(wav)
        if L <= short_limit:
            write_out(path, run([wav], L)[0][:L])
            continue
        groups[bucket_length(cfg, L)].append((path, L))
    for blen in sorted(groups):
        entries = groups[blen]
        for i in range(0, len(entries), args.batch):
            chunk = entries[i : i + args.batch]
            rows = [read(path) for path, _ in chunk]
            rows += [rows[-1]] * (args.batch - len(chunk))
            for (path, L), y in zip(chunk, run(rows, blen)):
                write_out(path, y[:L])


if __name__ == "__main__":
    main()
