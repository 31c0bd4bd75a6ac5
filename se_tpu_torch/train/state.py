"""Model and optimiser for training (counterpart of
``se_tpu/train/state.py``).

The JAX package threads params, batch statistics and the optax state
through its jitted step as one pytree; here they live where PyTorch keeps
them: parameters and BatchNorm buffers in the module, Adam's moments in
the optimiser (``torch.optim.Adam``, or :class:`AdamLowPrecisionMu` when
``TrainConfig.adam_mu_dtype`` narrows the first moment).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import Config
from ..models.factory import build_model


class AdamLowPrecisionMu(torch.optim.Optimizer):
    """optax's ``adam(lr, b1, b2, eps, mu_dtype=...)``, which
    ``torch.optim.Adam`` cannot express: the first moment is stored in
    ``mu_dtype`` (bf16), the second in f32.  Each step follows optax's
    ``scale_by_adam`` operation by operation: ``mu = (1 - b1) * g + b1 *
    mu_stored``, ``nu = (1 - b2) * g**2 + b2 * nu``, both bias-corrected in
    f32 by ``1 - b**count``, ``p += -lr * mu_hat / (sqrt(nu_hat) + eps)``;
    only then is ``mu`` stored in ``mu_dtype``.  The product ``b1 *
    mu_stored`` is taken in ``mu_dtype`` with ``b1`` itself rounded to it,
    as JAX casts a Python scalar to the array's dtype; the sum is f32."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 mu_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, mu_dtype=mu_dtype))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["count"] = 0
                    state["mu"] = torch.zeros_like(p, dtype=group["mu_dtype"])
                    state["nu"] = torch.zeros_like(p, dtype=torch.float32)
                state["count"] += 1
                b1_mu = torch.tensor(b1, dtype=group["mu_dtype"], device=g.device)
                mu = (1 - b1) * g + b1_mu * state["mu"]
                nu = (1 - b2) * g**2 + b2 * state["nu"]
                n = state["count"]
                update = (mu / (1 - b1**n)) / (torch.sqrt(nu / (1 - b2**n)) + group["eps"])
                p.add_(update * -group["lr"])
                state["mu"] = mu.to(group["mu_dtype"])
                state["nu"] = nu

    def load_state_dict(self, state_dict):
        """``Optimizer.load_state_dict`` casts every floating state tensor to
        its parameter's dtype; the first moment goes back to ``mu_dtype``
        (a widened bf16 value narrows to itself exactly)."""
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                if "mu" in self.state.get(p, {}):
                    self.state[p]["mu"] = self.state[p]["mu"].to(group["mu_dtype"])


def make_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.Optimizer:
    """Adam with lr ``cfg.train.learning_rate``, betas (0.9, 0.999), eps
    1e-8 outside the square root and no weight decay: optax's ``adam`` as
    the JAX package configures it (reference: train_interface.py:59).  With
    ``cfg.train.adam_mu_dtype`` (``"bfloat16"``) the first moment is stored
    in that dtype (:class:`AdamLowPrecisionMu`)."""
    kw = dict(lr=cfg.train.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    if cfg.train.adam_mu_dtype is not None:
        mu_dtype = getattr(torch, cfg.train.adam_mu_dtype, None)
        if not isinstance(mu_dtype, torch.dtype):
            raise ValueError(f"adam_mu_dtype must name a torch dtype, got "
                             f"{cfg.train.adam_mu_dtype!r}")
        return AdamLowPrecisionMu(model.parameters(), mu_dtype=mu_dtype, **kw)
    return torch.optim.Adam(model.parameters(), weight_decay=0.0, **kw)


def create_train_state(
    cfg: Config, state_dict: Optional[dict] = None, device="cuda"
) -> Tuple[torch.nn.Module, torch.optim.Optimizer]:
    """The model of ``cfg`` on ``device`` (``cuda`` unless the caller asks
    for ``"cpu"``), initialised from ``cfg.train.seed`` or loaded from
    ``state_dict`` with ``strict=True`` when one is given, and its optimiser
    -> ``(model, optimizer)``."""
    model = build_model(cfg, device=device, seed=cfg.train.seed)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model, make_optimizer(cfg, model)
