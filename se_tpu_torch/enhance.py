"""Batch enhancement with a DCCRN, CRN or FullSubNet checkpoint
(counterpart of the batch path of the repository's ``enhance.py``).

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
connections or with DCCRN's complex BatchNorm.  A DCCRN trained with
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
from .models.factory import build_model
from .models.fullsubnet import FullSubNet
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
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="activation dtype of the batch forward")
    args = p.parse_args(argv)
    if args.batch < 1:
        p.error(f"--batch must be >= 1 (got {args.batch})")
    if args.streaming:
        raise NotImplementedError(
            "--streaming is not ported yet (ROADMAP.md, Queue 1: streaming)"
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
    model = build_model(cfg, device=dev)
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
