"""Objective-metric checker CLI (counterpart of
``se_tpu/eval/check_object_metrics.py``; reference:
estimation/check_object_metrics.py), printing PESQ, STOI and the composite
measures CSIG, CBAK, COVL and segSNR.

Usage:
    python -m se_tpu_torch.eval.check_object_metrics clean.wav enhanced.wav
    python -m se_tpu_torch.eval.check_object_metrics --dir targets/ estimates/
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..data.wav import read_wav
from .composite import composite_measures
from .metrics import run_pesq_waveforms
from .stoi import stoi


def check_pair(clean_path: str, estimated_path: str):
    """PESQ, STOI, CSIG, CBAK, COVL and segSNR of one estimate against its
    target, both cut to the shorter length."""
    clean, fs = read_wav(clean_path)
    est, fs2 = read_wav(estimated_path)
    if fs != fs2:
        raise ValueError(f"sample rates differ: {clean_path} {fs} Hz, {estimated_path} {fs2} Hz")
    n = min(len(clean), len(est))
    clean, est = clean[:n], est[:n]
    pesq_score = run_pesq_waveforms(est, clean, fs)
    stoi_score = stoi(clean, est, fs, extended=False)
    # the composite of the same arrays, with the printed PESQ added to its
    # regressions (reference: tools_for_estimate.py:27-29)
    csig, cbak, covl, ssnr = composite_measures(clean, est, fs)
    csig += 0.603 * pesq_score
    cbak += 0.478 * pesq_score
    covl += 0.805 * pesq_score
    print(f"{os.path.basename(estimated_path)}: PESQ {pesq_score:.4f} | STOI {stoi_score:.4f} | "
          f"CSIG {csig:.4f} | CBAK {cbak:.4f} | COVL {covl:.4f} | segSNR {ssnr:.4f}")
    return pesq_score, stoi_score, csig, cbak, covl, ssnr


def check_dirs(target_dir: str, estimated_dir: str):
    """Score matching pairs: a target file ``X`` against the estimate whose
    name replaces 'target' with 'estimated', or has the same name."""
    results = []
    for name in sorted(os.listdir(target_dir)):
        if not name.endswith(".wav"):
            continue
        est_path = os.path.join(estimated_dir, name.replace("target", "estimated"))
        if not os.path.exists(est_path):
            est_path = os.path.join(estimated_dir, name)
        if not os.path.exists(est_path):
            print(f"skip {name}: no matching estimate")
            continue
        results.append(check_pair(os.path.join(target_dir, name), est_path))
    if results:
        mean = np.asarray(results).mean(axis=0)
        print(f"\nMEAN: PESQ {mean[0]:.4f} | STOI {mean[1]:.4f} | CSIG {mean[2]:.4f} | "
              f"CBAK {mean[3]:.4f} | COVL {mean[4]:.4f} | segSNR {mean[5]:.4f}")
    return results


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] == "--dir":
        if len(argv) != 3:
            print(__doc__)
            raise SystemExit("--dir needs TARGET_DIR and ESTIMATED_DIR")
        check_dirs(argv[1], argv[2])
    elif len(argv) == 2:
        check_pair(argv[0], argv[1])
    else:
        print(__doc__)
        if argv:
            raise SystemExit("expected: CLEAN.wav ENHANCED.wav")


if __name__ == "__main__":
    main()
