#!/usr/bin/env python3
"""Plant the faults that ``chip_smoke.py``'s resume check (phase 7) exists to
catch, and print what each reads against that check's limits.

    python3 resume_faults.py [cuda|cpu]

Run it from the root of a checkout on one NVIDIA H100 (``cuda``, the
default).  It trains the default DCCRN through the train CLI as phase 7
does (``chip_smoke._train_cli_data``: 8 + 4 utterances of 3 s, 2 epochs at
batch 4), then resumes a copy of the run as it stood after epoch 1 three
times, each in a process of its own:

- ``sound``: as phase 7 resumes;
- ``adam``: Adam's state dropped on restore (the model's weights only);
- ``order``: ``DataLoader.set_epoch`` left at epoch 0, so epoch 2 replays
  epoch 1's batches.

For each it prints ``[resume <fault>]`` with phase 7's summary, then
``RESUME <fault> {json}``: ``leaf``, the worst leaf of ``chkpt_2.pt`` over
its max outside the BatchNorm-cancelled biases, and ``leaf_at``, which;
``near``, the worst of those biases against ``bound``, Adam's; ``loss``,
the epoch-2 validation loss's relative difference
(``chip_smoke._resume_readings``).  It checks nothing: phase 7's limits
``RESUME_LEAF_TOL`` and ``RESUME_LOSS_TOL`` are set between the sound
runs' largest readings and the faults' smallest.
"""

from __future__ import annotations

import sys

FAULTS = ("sound", "adam", "order")

# The scoring pool's workers are spawned and import this file again as
# their main module: everything else is imported inside the functions.


def child(fault: str, argv: list) -> None:
    """Resume through the train CLI's ``main(argv)`` with ``fault`` planted,
    and take it out again after."""
    import torch

    from se_tpu_torch import train_interface
    from se_tpu_torch.train import loop

    def restore_model_only(path, model, optimizer):
        blob = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(blob["model"], strict=True)
        return int(blob["epoch"])

    restore, set_epoch = loop.restore_checkpoint, loop.DataLoader.set_epoch
    if fault == "adam":
        loop.restore_checkpoint = restore_model_only
    elif fault == "order":
        loop.DataLoader.set_epoch = lambda self, epoch: None
    elif fault != "sound":
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    try:
        train_interface.main(argv)
    finally:
        loop.restore_checkpoint, loop.DataLoader.set_epoch = restore, set_epoch


def main(device: str = "cuda") -> None:
    import json
    import subprocess
    import tempfile
    from pathlib import Path

    import chip_smoke as cs
    from se_tpu_torch import train_interface
    from se_tpu_torch.config import Config

    if device == "cuda":
        cs.phase_environment()
    cfg = Config()
    build_dir = cs.REPO / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        common, _ = cs._train_cli_data(Path(tmp), device, cfg.stft.fs)
        trainer = train_interface.main(common)
        run = Path(trainer.dir_to_save)
        names = [k for k, _ in trainer.model.named_parameters()]
        for fault in FAULTS:
            copy = cs._resume_copy(run, fault)
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--child", fault, *common,
                 "--chkpt-model", copy.name, "--chkpt", "1"],
                cwd=cs.REPO, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"resume {fault} exited {proc.returncode}:\n"
                                   f"{proc.stderr[-3000:]}")
            r = cs._resume_readings(run, copy, names, cfg.train.learning_rate)
            print(f"[resume {fault}] {cs._resume_summary(r)}")
            leaf_at = max(r["rel"], key=r["rel"].get)
            print("RESUME", fault, json.dumps(dict(
                leaf=r["rel"][leaf_at], leaf_at=leaf_at, near=max(r["near"].values()),
                bound=r["bound"], loss=float(r["loss"]))), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], sys.argv[3:])
    else:
        main(*sys.argv[1:2])
