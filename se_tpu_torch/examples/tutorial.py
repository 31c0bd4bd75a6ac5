"""Zero-preparation end-to-end tutorial (counterpart of
``examples/tutorial.py``; reference: SE_tutorials.ipynb, README.md:55-57):
the tutorial configuration (CRN, E mask, MSE, the real LSTM) at narrow
widths, trained on a synthetic corpus in the reference's ``[N, 2, T]``
layout.

    python -m se_tpu_torch.examples.tutorial               # on the card
    python -m se_tpu_torch.examples.tutorial --device cpu

The run directory (``log.txt``, checkpoints, per-utterance scores) goes
under ``--job-dir``, the tensorboard logs under ``--logs-dir``.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..config import CrnConfig, DccrnConfig, TrainConfig, tutorial_config
from ..train.loop import Trainer


def synthetic_corpus(n: int, seed: int, length: int, fs: int = 16000) -> np.ndarray:
    """``[n, 2, length]`` rows of (noisy, clean): a 440 Hz tone gated at
    3 Hz, plus white noise from ``seed``.  The notebook trains on
    ``np.ones``; noisy-speech-shaped rows train more meaningfully."""
    t = np.arange(length) / fs
    clean = 0.2 * np.sin(2 * np.pi * 440 * t) * np.clip(np.sin(2 * np.pi * 3 * t), 0, None)
    r = np.random.default_rng(seed)
    out = np.empty((n, 2, length), np.float32)
    for i in range(n):
        out[i, 0] = clean + 0.05 * r.standard_normal(length)
        out[i, 1] = clean
    return out


def main(argv=None) -> np.ndarray:
    """Train the tutorial's CRN -> the validation loss of each epoch."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--n-train", type=int, default=300, help="training utterances")
    p.add_argument("--n-valid", type=int, default=50, help="validation utterances")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--seconds", type=float, default=1.0, help="length of each utterance")
    p.add_argument("--batch", type=int, default=10)
    p.add_argument("--job-dir", default="./models/")
    p.add_argument("--logs-dir", default="./logs/")
    args = p.parse_args(argv)

    # tutorial scale: narrow channels, so that CPU epochs are quick too
    cfg = tutorial_config().replace(
        dccrn=DccrnConfig(kernel_num=(8, 16, 16, 32, 32, 32)),
        crn=CrnConfig(rnn_input_size=(32 // 2) * 4, rnn_units=32),
        train=TrainConfig(max_epochs=args.epochs, batch=args.batch, job_dir=args.job_dir,
                          logs_dir=args.logs_dir),
    )
    length = int(round(args.seconds * cfg.stft.fs))
    train_data = synthetic_corpus(args.n_train, 1, length, cfg.stft.fs)
    valid_data = synthetic_corpus(args.n_valid, 2, length, cfg.stft.fs)

    trainer = Trainer(cfg, train_data, valid_data, device=args.device)
    trainer.setup()
    mse = trainer.run()[: cfg.train.max_epochs]
    print("validation losses per epoch:", mse)
    return mse


if __name__ == "__main__":
    main()
