"""Build a synthetic corpus through the port's product data pipeline
(counterpart of ``tools/make_synth_corpus.py``): synthetic clean-speech and
noise wav trees -> :func:`synth.generate_corpus` (the reference's
generate_noisy_data.py workflow) -> :func:`synth.pack_corpus` -> the
``[N, 2, T]`` ``.npy`` files ``se_tpu_torch.train_interface`` reads.

reference: README.md:33-52 (dataset preparation workflow),
generate_noisy_data.py:70-168 (train: every clean file at every SNR with a
random noise file; validation: one random SNR per file).

    python -m se_tpu_torch.data.make_synth_corpus [root] [n_train] [n_valid] [n_test]

Layout written under ``root`` (defaults ``runs/corpus``, 256, 48, 24):

    train/clean/*.wav   n_train clean utterances (speechlike, varied f0)
    train/noise/*.wav   8 noise files of 10 s (white, pink, AM, babble-like,
                        twice), shared by every mode
    valid/clean/*.wav   n_valid clean utterances (another f0 band and seed)
    test/clean/*.wav    n_test clean utterances (held out from training)
    {mode}/noisy/*.wav and {mode}/log.tsv   from generate_corpus
    train.npy / valid.npy / test.npy        packed [N, 2, 48000] float32

The seeds (1234 for the noise tree; 10, 20, 30 for the clean trees; 40,
41, 42 for the mixes) and the SNR lists are the JAX tool's, so the same
arguments give the same arrays in both packages.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .synth import generate_corpus, pack_corpus, write_wav

FS = 16000
SECONDS = 3.0
NOISE_KINDS = ("white", "pink", "am", "babble") * 2
NOISE_SECONDS = 10


def speechlike(rng: np.random.Generator, n: int = 48000, fs: int = 16000,
               f0: float = 120.0) -> np.ndarray:
    """Synthetic voiced 'speech': pitch harmonics under a formant envelope,
    syllabic amplitude modulation and pauses, peak 0.25."""
    t = np.arange(n) / fs
    harmonics = np.zeros(n)
    for k in range(1, 30):
        f = k * f0
        if f > 7000:
            break
        formant = (
            np.exp(-(((f - 500) / 300) ** 2))
            + 0.7 * np.exp(-(((f - 1500) / 400) ** 2))
            + 0.4 * np.exp(-(((f - 2500) / 500) ** 2))
        )
        harmonics += formant / k * np.sin(2 * np.pi * f * t + rng.uniform(0, 6))
    syllable = np.clip(np.sin(2 * np.pi * 4 * t + rng.uniform(0, 6)), 0, None)
    pauses = (np.sin(2 * np.pi * 0.7 * t) > -0.3).astype(float)
    x = harmonics * syllable * pauses
    x += 0.003 * rng.standard_normal(n)
    return 0.25 * x / np.max(np.abs(x))


def make_noise(rng: np.random.Generator, kind: str, n: int) -> np.ndarray:
    """``n`` samples of ``kind`` noise (white, pink: 1/f shaped, am:
    amplitude-modulated white, else babble-like: six speechlike talkers),
    peak 0.2."""
    if kind == "white":
        x = rng.standard_normal(n)
    elif kind == "pink":
        spec = np.fft.rfft(rng.standard_normal(n))
        f = np.arange(len(spec), dtype=np.float64)
        f[0] = 1.0
        x = np.fft.irfft(spec / np.sqrt(f), n)
    elif kind == "am":
        t = np.arange(n) / FS
        x = rng.standard_normal(n) * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * t))
    else:
        x = sum(speechlike(rng, n=n, f0=rng.uniform(90, 260)) for _ in range(6))
    return 0.2 * x / np.max(np.abs(x))


def make_noise_tree(root: str) -> None:
    """``{root}/train/noise``: one file of ``NOISE_SECONDS`` per
    ``NOISE_KINDS`` entry, from one generator seeded 1234 (generate_corpus
    reads this tree in every mode)."""
    rng = np.random.default_rng(1234)
    d = os.path.join(root, "train", "noise")
    os.makedirs(d, exist_ok=True)
    for i, kind in enumerate(NOISE_KINDS):
        write_wav(os.path.join(d, f"noise_{i}_{kind}.wav"),
                  make_noise(rng, kind, NOISE_SECONDS * FS), FS)


def make_clean_tree(root: str, mode: str, n: int, f0_lo: float, f0_hi: float,
                    seed: int) -> None:
    """``{root}/{mode}/clean``: ``n`` speechlike utterances of ``SECONDS``,
    their f0 spread over ``[f0_lo, f0_hi]`` with a jitter of 2 Hz."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, mode, "clean")
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        f0 = f0_lo + (f0_hi - f0_lo) * (i / max(n - 1, 1)) + rng.uniform(-2, 2)
        write_wav(os.path.join(d, f"{mode}_{i:04d}.wav"),
                  speechlike(rng, n=int(SECONDS * FS), f0=f0), FS)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    root = argv[0] if len(argv) > 0 else "runs/corpus"
    n_train = int(argv[1]) if len(argv) > 1 else 256
    n_valid = int(argv[2]) if len(argv) > 2 else 48
    n_test = int(argv[3]) if len(argv) > 3 else 24
    os.makedirs(root, exist_ok=True)

    make_noise_tree(root)
    # disjoint f0 bands and seeds keep valid and test held out
    make_clean_tree(root, "train", n_train, 80, 200, seed=10)
    make_clean_tree(root, "valid", n_valid, 95, 215, seed=20)
    make_clean_tree(root, "test", n_test, 105, 225, seed=30)

    generate_corpus("train", [0.0, 5.0], FS, root=root, seed=40)
    generate_corpus("valid", [0.0, 5.0, 10.0], FS, root=root, seed=41)
    generate_corpus("test", [0.0, 5.0, 10.0], FS, root=root, seed=42)
    for mode in ("train", "valid", "test"):
        out = os.path.join(root, f"{mode}.npy")
        pack_corpus(mode, out, SECONDS, FS, root=root)
        arr = np.load(out, mmap_mode="r")
        print(f"{out}: {arr.shape} {arr.dtype}")


if __name__ == "__main__":
    main()
