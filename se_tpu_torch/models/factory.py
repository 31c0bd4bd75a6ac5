"""Model factory (counterpart of ``se_tpu/models/factory.py``)."""

from __future__ import annotations

import torch

from ..config import Config
from ..device import resolve_device
from .crn import CRN
from .dccrn import DCCRN
from .fullsubnet import FullSubNet
from .streaming import StreamingDCCRN
from .streaming_crn import StreamingCRN
from .streaming_fullsubnet import StreamingFullSubNet

_MODELS = {"DCCRN": DCCRN, "CRN": CRN, "FullSubNet": FullSubNet}
_STREAMING = {"DCCRN": StreamingDCCRN, "CRN": StreamingCRN, "FullSubNet": StreamingFullSubNet}


def build_model(cfg: Config, device="cuda", seed: int = 0) -> torch.nn.Module:
    """The model of ``cfg`` on ``device``, in eval mode, with the
    reference's initialisation drawn from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    model = _MODELS[cfg.model](cfg, generator=torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def build_stream_model(cfg: Config, device="cuda", seed: int = 0) -> torch.nn.Module:
    """The chunk-streaming model of ``cfg`` (``StreamingDCCRN``,
    ``StreamingCRN`` or ``StreamingFullSubNet``), as :func:`build_model`:
    the batch model's parameters and buffers under the same names."""
    dev = resolve_device(device)
    model = _STREAMING[cfg.model](cfg, generator=torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
