"""Train and validation steps (counterpart of the masking and
``crn_direct`` variants of ``make_train_step`` and ``make_eval_step`` in
``se_tpu/train/steps.py``)."""

from __future__ import annotations

import torch

from ..config import Config
from ..losses import main_loss

# where each trainer variant that is not ported yet stands in ROADMAP.md
_NOT_PORTED = {
    "perceptual": "Queue 1 item 9",
    "fullsubnet": "Queue 1 item 10",
    "dccrn_direct": "Queue 1 item 7",
}
_PORTED = ("masking", "crn_direct")


def trainer_variant(cfg: Config) -> str:
    """The reference's five-way trainer dispatch."""
    if cfg.perceptual is not False:
        return "perceptual"
    if cfg.model == "FullSubNet":
        return "fullsubnet"
    if cfg.masking_mode == "Direct(None make)":
        return "dccrn_direct" if cfg.model == "DCCRN" else "crn_direct"
    return "masking"


def _require_ported(cfg: Config, what: str) -> str:
    variant = trainer_variant(cfg)
    if variant not in _PORTED:
        raise NotImplementedError(
            f"the {variant!r} {what} is not ported yet (ROADMAP.md, {_NOT_PORTED[variant]})"
        )
    return variant


def _loss_and_outputs(cfg: Config, variant: str, model, inputs, targets):
    """The variant's loss and the enhanced waveforms: ``masking`` scores the
    waveform against the clean one; ``crn_direct`` scores CRN's magnitude
    against the clean magnitude."""
    if variant == "crn_direct":
        out_mag, tgt_mag, outputs = model(inputs, targets)
        return main_loss(cfg.loss, out_mag, tgt_mag), outputs
    _, _, outputs = model(inputs)
    return main_loss(cfg.loss, outputs, targets), outputs


def _batch(model: torch.nn.Module, inputs, targets):
    dev = next(model.parameters()).device
    return (torch.as_tensor(inputs, dtype=torch.float32, device=dev),
            torch.as_tensor(targets, dtype=torch.float32, device=dev))


def train_step(cfg: Config, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               inputs, targets) -> dict:
    """One optimisation step on a ``(noisy, clean)`` batch, both ``[B, L]``,
    on the model's device -> ``{"loss": scalar}`` (the mean over
    micro-batches, detached).

    The model is put in train mode: BatchNorm normalises with the batch's
    statistics and moves its running buffers.  With ``cfg.train.grad_accum
    = A > 1`` the batch runs as A sequential micro-batches of ``B / A``
    rows; each updates the running statistics in turn, their gradients are
    summed and divided by A, and the optimiser takes one step, as the JAX
    step's scan does.  The averaged gradients are left in each
    parameter's ``.grad``.
    """
    variant = _require_ported(cfg, "train step")
    accum = cfg.train.grad_accum
    inputs, targets = _batch(model, inputs, targets)
    if inputs.shape[0] % accum:
        raise ValueError(f"batch {inputs.shape[0]} does not split into {accum} micro-batches")
    model.train()
    params = [p for p in model.parameters() if p.requires_grad]
    # Summed out of place, not by repeated backward(): autograd may hand
    # two parameters views of one gradient tensor (an LSTM's b_ih and b_hh
    # both receive the gradient of their sum), and an in-place
    # accumulation into one would then add to the other as well.
    grads, total = None, 0.0
    for x, y in zip(inputs.chunk(accum), targets.chunk(accum)):
        loss, _ = _loss_and_outputs(cfg, variant, model, x, y)
        g = torch.autograd.grad(loss, params)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        total = total + loss.detach()
    for p, g in zip(params, grads):
        p.grad = g / accum
    optimizer.step()
    return {"loss": total / accum}


def eval_step(cfg: Config, model: torch.nn.Module, inputs, targets):
    """Loss and enhanced waveforms of one ``(noisy, clean)`` batch, both
    ``[B, L]``, on the model's device -> ``({"loss": scalar}, wavs [B, L'])``."""
    variant = _require_ported(cfg, "eval step")
    model.eval()
    with torch.inference_mode():
        inputs, targets = _batch(model, inputs, targets)
        loss, outputs = _loss_and_outputs(cfg, variant, model, inputs, targets)
    return {"loss": loss}, outputs
