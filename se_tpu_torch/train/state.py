"""Model and optimiser for training (counterpart of
``se_tpu/train/state.py``).

The JAX package threads params, batch statistics and the optax state
through its jitted step as one pytree; here they live where PyTorch keeps
them: parameters and BatchNorm buffers in the module, Adam's moments in a
``torch.optim.Adam``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import Config
from ..models.factory import build_model


def make_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.Optimizer:
    """Adam with lr ``cfg.train.learning_rate``, betas (0.9, 0.999), eps
    1e-8 outside the square root and no weight decay: optax's ``adam`` as
    the JAX package configures it (reference: train_interface.py:59)."""
    if cfg.train.adam_mu_dtype is not None:
        raise NotImplementedError(
            "adam_mu_dtype is not ported yet (ROADMAP.md, Queue 1 item 6: bf16)"
        )
    return torch.optim.Adam(
        model.parameters(), lr=cfg.train.learning_rate, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=0.0,
    )


def create_train_state(
    cfg: Config, state_dict: Optional[dict] = None, device="cuda"
) -> Tuple[torch.nn.Module, torch.optim.Optimizer]:
    """The model of ``cfg`` on ``device`` (``cuda`` unless the caller asks
    for ``"cpu"``), loaded from ``state_dict`` with ``strict=True`` when one
    is given, and its optimiser -> ``(model, optimizer)``."""
    model = build_model(cfg, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model, make_optimizer(cfg, model)
