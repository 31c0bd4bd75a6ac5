"""Batch enhancement with a DCCRN or CRN checkpoint (counterpart of the
DCCRN/CRN batch path of the repository's ``enhance.py``).

    python -m se_tpu_torch.enhance --checkpoint chkpt.pt --model DCCRN \\
        [--lstm complex] [--masking-mode E] [--batch N] [--device cuda] \\
        noisy1.wav ... --out-dir DIR
    python -m se_tpu_torch.enhance --checkpoint chkpt.pt --model CRN noisy.wav

The checkpoint is the reference's ``{'model', 'optimizer', 'epoch'}``
blob, as ``python -m se_tpu.utils.torch_export`` writes it.  Runs on the
card unless ``--device cpu`` is given.  Files are zero-padded to whole
seconds before the forward and trimmed after it, as the JAX CLI's
bucketed path does; files no longer than one analysis window run at their
exact length.  ``--batch N`` stacks files of the same one-second bucket
into batches of N rows, padding the last batch of a bucket by repeating
its last row; rows are independent, so each output matches its
``--batch 1`` run up to float rounding.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np
import torch

from .config import Config
from .data.wav import read_wav, write_wav
from .device import resolve_device
from .models.factory import build_model
from .utils.weights import load_reference_checkpoint


def enhance_batch(model: torch.nn.Module, wavs, device="cuda") -> torch.Tensor:
    """Enhance ``wavs [B, L]`` with ``model`` on ``device`` -> ``[B, L']``,
    ``L' = L`` when L is a multiple of the STFT hop (else the last partial
    hop is dropped, as in the reference)."""
    dev = resolve_device(device)
    model.to(dev).eval()
    with torch.inference_mode():
        x = torch.as_tensor(wavs, dtype=torch.float32).to(dev)
        if x.ndim != 2:
            raise ValueError(f"wavs must be [B, L], got {tuple(x.shape)}")
        return model(x)[-1]


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("wavs", nargs="+")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--model", default="DCCRN", choices=["DCCRN", "CRN", "FullSubNet"])
    p.add_argument("--masking-mode", default="E")
    p.add_argument("--lstm", default="complex", choices=["complex", "real"])
    p.add_argument("--out-dir", default="enhanced")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    args = p.parse_args(argv)
    if args.batch < 1:
        p.error(f"--batch must be >= 1 (got {args.batch})")
    if args.streaming:
        raise NotImplementedError(
            "--streaming is not ported yet (ROADMAP.md, Queue 1: streaming)"
        )
    if args.compute_dtype != "float32":
        raise NotImplementedError(
            "--compute-dtype bfloat16 is not ported yet (ROADMAP.md, Queue 1: bf16 streams)"
        )
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        p.error(str(e))

    cfg = Config(model=args.model, masking_mode=args.masking_mode, lstm=args.lstm)
    model = build_model(cfg, device=dev)
    model.load_state_dict(load_reference_checkpoint(args.checkpoint)[0], strict=True)
    os.makedirs(args.out_dir, exist_ok=True)
    fs = cfg.stft.fs
    short_limit = cfg.stft.win_len

    def padded_len(L: int) -> int:
        return -(-L // fs) * fs

    def run(rows, length: int) -> np.ndarray:
        buf = np.stack([np.pad(w, (0, length - len(w))) for w in rows])
        return enhance_batch(model, buf, dev).cpu().numpy()

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
            length = L if L <= short_limit else padded_len(L)
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
        groups[padded_len(L)].append((path, L))
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
