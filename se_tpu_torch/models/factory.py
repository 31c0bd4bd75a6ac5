"""Model factory (counterpart of ``se_tpu/models/factory.py``)."""

from __future__ import annotations

import torch

from ..config import Config
from ..device import resolve_device
from .crn import CRN
from .dccrn import DCCRN
from .fullsubnet import FullSubNet

_MODELS = {"DCCRN": DCCRN, "CRN": CRN, "FullSubNet": FullSubNet}


def build_model(cfg: Config, device="cuda") -> torch.nn.Module:
    """The model of ``cfg`` on ``device``, in eval mode, with the
    reference's initialisation drawn from a generator seeded with 0."""
    dev = resolve_device(device)
    model = _MODELS[cfg.model](cfg, generator=torch.Generator().manual_seed(0))
    return model.to(dev).eval()
