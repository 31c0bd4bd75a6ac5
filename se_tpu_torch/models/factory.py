"""Model factory (counterpart of ``se_tpu/models/factory.py``)."""

from __future__ import annotations

import torch

from ..config import Config
from ..device import resolve_device
from .crn import CRN
from .dccrn import DCCRN
from .fullsubnet import FullSubNet

_MODELS = {"DCCRN": DCCRN, "CRN": CRN, "FullSubNet": FullSubNet}


def build_model(cfg: Config, device="cuda", seed: int = 0) -> torch.nn.Module:
    """The model of ``cfg`` on ``device``, in eval mode, with the
    reference's initialisation drawn from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    model = _MODELS[cfg.model](cfg, generator=torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
