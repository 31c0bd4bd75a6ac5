"""Validation forward (counterpart of the masking variant of
``make_eval_step`` in ``se_tpu/train/steps.py``).  The train step comes
with the training slice."""

from __future__ import annotations

import torch

from ..config import Config
from ..losses import main_loss


def trainer_variant(cfg: Config) -> str:
    """The reference's five-way trainer dispatch."""
    if cfg.perceptual is not False:
        return "perceptual"
    if cfg.model == "FullSubNet":
        return "fullsubnet"
    if cfg.masking_mode == "Direct(None make)":
        return "dccrn_direct" if cfg.model == "DCCRN" else "crn_direct"
    return "masking"


def eval_step(cfg: Config, model: torch.nn.Module, inputs, targets):
    """Loss and enhanced waveforms of one ``(noisy, clean)`` batch, both
    ``[B, L]``, on the model's device -> ``({"loss": scalar}, wavs [B, L'])``."""
    variant = trainer_variant(cfg)
    if variant != "masking":
        raise NotImplementedError(
            f"the {variant!r} eval step is not ported yet (ROADMAP.md, Queue 1)"
        )
    dev = next(model.parameters()).device
    model.eval()
    with torch.inference_mode():
        inputs = torch.as_tensor(inputs, dtype=torch.float32, device=dev)
        targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
        _, _, outputs = model(inputs)
        loss = main_loss(cfg.loss, outputs, targets)
    return {"loss": loss}, outputs
