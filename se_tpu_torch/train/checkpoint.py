"""Checkpoints in the reference's own format (counterpart of
``se_tpu/train/checkpoint.py``).

Each epoch writes ``{dir}/chkpt_{N}.pt``, a ``torch.save`` of ``{'model':
state_dict, 'optimizer': optimizer.state_dict(), 'epoch': N}``, before
validation (reference: train_interface.py:166-171, :205-210).  Resume
restores both state dicts and continues at epoch N + 1 (:101-116); after
training the best epoch is copied to ``chkpt_opt.pt`` (:233-239).
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from ..utils.weights import save_reference_checkpoint


def checkpoint_path(dir_to_save: str, epoch) -> str:
    return os.path.join(dir_to_save, f"chkpt_{epoch}.pt")


def save_checkpoint(dir_to_save: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, epoch: int) -> str:
    """Write epoch ``epoch``'s blob; it appears under its name only once
    written whole."""
    path = checkpoint_path(dir_to_save, epoch)
    save_reference_checkpoint(path + ".tmp", model.state_dict(), epoch, optimizer.state_dict())
    os.replace(path + ".tmp", path)
    return path


def restore_checkpoint(path: str, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer) -> int:
    """Load a blob into ``model`` (``strict=True``) and ``optimizer``, each
    onto its own device -> the blob's epoch.  Only tensors, plain
    containers and dtypes are accepted (``weights_only``)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(blob["model"], strict=True)
    optimizer.load_state_dict(blob["optimizer"])
    return int(blob["epoch"])


def copy_best_checkpoint(dir_to_save: str, mse_vali_total: np.ndarray) -> str:
    """Copy the epoch of least validation loss to ``chkpt_opt.pt``.

    Exact-0.0 entries are epochs never validated (the array starts at
    zeros, and a real validation loss is never exactly 0.0): a run that
    stopped between a checkpoint and its validation, or before
    ``max_epochs``, must not promote an unvalidated checkpoint through a
    placeholder zero, as the reference's argmin over the padded array
    would.  The zeros stay in the saved array, the reference's format."""
    validated = mse_vali_total != 0.0
    candidates = np.where(validated, mse_vali_total, np.inf) if validated.any() else mse_vali_total
    best = int(np.argmin(candidates)) + 1
    return shutil.copyfile(checkpoint_path(dir_to_save, best), checkpoint_path(dir_to_save, "opt"))
