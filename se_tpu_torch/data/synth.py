"""Noisy-mixture synthesis (counterpart of ``se_tpu/data/synth.py``): the
offline corpus (a wav tree mixed at given SNRs, then packed into the
``[N, 2, T]`` array the loader reads) and ``mix_at_snr``, which also
serves the on-the-fly ``MixingDataset``.

reference: generate_noisy_data.py — random noise crop (:52-54), DC removal
and signal powers (:57-60), SNR scale alpha = sqrt(10^(-snr/10) * Ps / Pn)
(:63); train mode mixes every clean file at every requested SNR with a
random noise file, validation picks a random SNR per file (:102-168).

The draws from the seeded generator come in the JAX package's order (train:
for each SNR, for each clean file, the noise index, then the crop;
validation: the SNR index, the noise index, the crop), so one seed writes
the same files in both packages, bit for bit.

    python -m se_tpu_torch.data.synth [mode] [snr_csv] [fs]
    python -m se_tpu_torch.data.synth pack [mode] [out.npy] [seconds] [fs]
"""

from __future__ import annotations

import os
import sys
from typing import List, Tuple

import numpy as np

from .wav import read_wav, write_wav

__all__ = ["scan_directory", "read_wav", "write_wav", "mix_at_snr", "generate_noisy_wav",
           "generate_corpus", "pack_corpus", "main"]


def scan_directory(dir_name: str) -> List[str]:
    """The ``.wav`` paths under ``dir_name``, recursively, sorted
    (reference: generate_noisy_data.py:23-43)."""
    if not os.path.isdir(dir_name):
        raise FileNotFoundError(f"{dir_name} is not a valid directory")
    out = []
    for root, _, files in os.walk(dir_name):
        out += [os.path.join(root, f) for f in files if f.endswith(".wav")]
    return sorted(out)


def mix_at_snr(
    clean: np.ndarray,
    noise: np.ndarray,
    snr_db: float,
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mix a random crop of ``noise`` into ``clean`` at ``snr_db`` ->
    ``(noisy, clean)``, the reference's mixing: a random crop (the noise
    tiled when it is not longer than the speech), each signal's mean
    removed, and the noise scaled by ``sqrt(10**(-snr/10) * Ps / Pn)``."""
    rng = rng or np.random.default_rng()
    if len(noise) <= len(clean):
        reps = -(-len(clean) // len(noise)) + 1
        noise = np.tile(noise, reps)
    start = rng.integers(0, len(noise) - len(clean))
    noise_seg = noise[start : start + len(clean)]

    clean = clean - np.mean(clean)
    noise_seg = noise_seg - np.mean(noise_seg)
    p_speech = np.mean(clean**2)
    p_noise = np.mean(noise_seg**2) + 1e-20
    alpha = np.sqrt(10.0 ** (-snr_db / 10.0) * p_speech / p_noise)
    return clean + alpha * noise_seg, clean


def generate_noisy_wav(
    clean_path: str,
    noise_path: str,
    snr_db: float,
    fs: int = 16000,
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Both files read at ``fs`` (resampled where they are not) and mixed by
    :func:`mix_at_snr` -> ``(noisy, clean)``."""
    clean, _ = read_wav(clean_path, fs)
    noise, _ = read_wav(noise_path, fs)
    return mix_at_snr(clean, noise, snr_db, rng)


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def generate_corpus(
    mode: str,
    snrs: List[float],
    fs: int = 16000,
    root: str = ".",
    seed: int = 0,
) -> str:
    """Mix ``{root}/{mode}/clean`` with ``{root}/train/noise`` into
    ``{root}/{mode}/noisy`` and write the TSV log ``{root}/{mode}/log.tsv``
    (clean path, noise path, SNR, noisy name) -> the log's path.  Train mode:
    every clean file at every SNR, each with a random noise file; any other
    mode: one random SNR per clean file (reference: generate_noisy_data.py:70-168)."""
    rng = np.random.default_rng(seed)
    out_dir = os.path.join(root, mode, "noisy")
    os.makedirs(out_dir, exist_ok=True)
    clean_files = scan_directory(os.path.join(root, mode, "clean"))
    noise_files = scan_directory(os.path.join(root, "train", "noise"))
    log_path = os.path.join(root, mode, "log.tsv")

    def mix(cf, snr, log):
        nf = noise_files[rng.integers(0, len(noise_files))]
        noisy, _ = generate_noisy_wav(cf, nf, snr, fs, rng)
        # train mode names the noise file too: a clean file is mixed at every SNR
        name = _stem(cf) + (f"_{_stem(nf)}" if mode == "train" else "") + f"_{snr}dB.wav"
        write_wav(os.path.join(out_dir, name), noisy, fs)
        log.write(f"{cf}\t{nf}\t{snr}\t{name}\n")

    with open(log_path, "w") as log:
        if mode == "train":
            for snr in snrs:
                for cf in clean_files:
                    mix(cf, snr, log)
        else:
            for cf in clean_files:
                mix(cf, snrs[rng.integers(0, len(snrs))], log)
    return log_path


def pack_corpus(
    mode: str,
    out_path: str,
    seconds: float = 3.0,
    fs: int = 16000,
    root: str = ".",
) -> str:
    """Pack the wav tree that :func:`generate_corpus` logged into the
    ``[N, 2, T]`` float32 ``.npy`` the loader reads (rows: noisy, clean),
    each file front-cropped to ``seconds * fs`` samples or zero-padded to
    them -> ``out_path``.  An empty log raises ``ValueError``."""
    T = int(round(seconds * fs))
    log_path = os.path.join(root, mode, "log.tsv")
    noisy_dir = os.path.join(root, mode, "noisy")

    def fit(x: np.ndarray) -> np.ndarray:
        x = x[:T]
        return x if len(x) == T else np.pad(x, (0, T - len(x)))

    pairs = []
    with open(log_path) as log:
        for line in log:
            cf, _nf, _snr, name = line.rstrip("\n").split("\t")
            clean, _ = read_wav(cf, target_fs=fs)
            noisy, _ = read_wav(os.path.join(noisy_dir, name), target_fs=fs)
            pairs.append(np.stack([fit(noisy), fit(clean)]))
    if not pairs:
        raise ValueError(f"no entries in {log_path}")
    np.save(out_path, np.stack(pairs).astype(np.float32))
    return out_path


def main(argv=None):
    """``[mode] [snr_csv] [fs]`` synthesizes ``mode``'s tree under the
    working directory (defaults ``train``, ``0,5``, 16000); ``pack [mode]
    [out.npy] [seconds] [fs]`` packs it (defaults ``train``, ``{mode}.npy``,
    3.0, 16000)."""
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "pack":
        mode = argv[1] if len(argv) > 1 else "train"
        out = argv[2] if len(argv) > 2 else f"{mode}.npy"
        seconds = float(argv[3]) if len(argv) > 3 else 3.0
        fs = int(argv[4]) if len(argv) > 4 else 16000
        print(f"wrote packed corpus: {pack_corpus(mode, out, seconds, fs)}")
        return
    mode = argv[0] if argv else "train"
    snrs = [float(s) for s in (argv[1] if len(argv) > 1 else "0,5").split(",")]
    fs = int(argv[2]) if len(argv) > 2 else 16000
    print(f"wrote corpus log: {generate_corpus(mode, snrs, fs)}")


if __name__ == "__main__":
    main()
