"""Model factory (counterpart of ``se_tpu/models/factory.py``)."""

from __future__ import annotations

import math

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


# jax.nn.initializers.xavier_normal draws a normal truncated at 2 of its
# unit scale, scaled up by 1 / this (the truncated unit normal's std) so
# that its variance is Xavier's
_TRUNCATED_STD = 0.87962566103423978


def apply_reference_weight_init(model: torch.nn.Module, generator: torch.Generator) -> None:
    """FullSubNet's optional init table (``fullsubnet.weight_init``;
    ``se_tpu/models/factory.py:66-89``), in place, each leaf in
    ``named_parameters`` order drawn from ``generator``: orthogonal for a
    leaf of two or more dims named ``weight_ih*`` or ``weight_hh*`` (the
    LSTM's or GRU's), Xavier-normal for ``fc_output_layer.weight`` (as
    JAX's, a normal truncated at 2 of its unit scale, scaled to Xavier's
    variance), standard normal for every 1-D leaf; every other leaf as it
    was."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1:
                p.copy_(torch.randn(p.shape, generator=generator))
            elif "weight_ih" in name or "weight_hh" in name:
                torch.nn.init.orthogonal_(p, generator=generator)
            elif "fc_output_layer.weight" in name:
                std = math.sqrt(2.0 / sum(p.shape)) / _TRUNCATED_STD
                torch.nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)


def _init(model: torch.nn.Module, cfg: Config, seed: int) -> torch.nn.Module:
    """``model`` with FullSubNet's optional init table applied where the
    config asks, from a generator seeded ``seed + 1`` (as the JAX package
    keys it with ``PRNGKey(seed + 1)``)."""
    if cfg.model == "FullSubNet" and cfg.fullsubnet.weight_init:
        apply_reference_weight_init(model, torch.Generator().manual_seed(seed + 1))
    return model


def build_model(cfg: Config, device="cuda", seed: int = 0) -> torch.nn.Module:
    """The model of ``cfg`` on ``device``, in eval mode, with the
    reference's initialisation drawn from a generator seeded with ``seed``
    (and, for FullSubNet with ``weight_init``, its init table from one
    seeded ``seed + 1``)."""
    dev = resolve_device(device)
    model = _MODELS[cfg.model](cfg, generator=torch.Generator().manual_seed(seed))
    return _init(model, cfg, seed).to(dev).eval()


def build_stream_model(cfg: Config, device="cuda", seed: int = 0) -> torch.nn.Module:
    """The chunk-streaming model of ``cfg`` (``StreamingDCCRN``,
    ``StreamingCRN`` or ``StreamingFullSubNet``), as :func:`build_model`:
    the batch model's parameters and buffers under the same names."""
    dev = resolve_device(device)
    model = _STREAMING[cfg.model](cfg, generator=torch.Generator().manual_seed(seed))
    return _init(model, cfg, seed).to(dev).eval()
