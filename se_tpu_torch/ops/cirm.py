"""Compressed complex ideal ratio mask (counterpart of
``se_tpu/ops/cirm.py``): FullSubNet's training target and its inference
decode."""

from __future__ import annotations

import numpy as np
import torch

EPSILON = float(np.finfo(np.float32).eps)


def build_complex_ideal_ratio_mask(noisy: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
    """``[B, F, T]`` complex noisy and clean spectra -> ``[B, F, T, 2]``
    compressed cIRM."""
    nr, ni = noisy.real, noisy.imag
    cr, ci = clean.real, clean.imag
    denominator = nr.square() + ni.square() + EPSILON
    mask_real = (nr * cr + ni * ci) / denominator
    mask_imag = (nr * ci - ni * cr) / denominator
    return compress_cIRM(torch.stack((mask_real, mask_imag), dim=-1), K=10, C=0.1)


def compress_cIRM(mask: torch.Tensor, K: float = 10, C: float = 0.1) -> torch.Tensor:
    """(-inf, inf) -> (-K, K): ``K (1 - e^{-C m}) / (1 + e^{-C m})``, with
    ``m`` clamped from below at -100."""
    mask = torch.where(mask <= -100, torch.full_like(mask, -100.0), mask)
    e = torch.exp(-C * mask)
    return K * (1 - e) / (1 + e)


def decompress_cIRM(mask: torch.Tensor, K: float = 10, limit: float = 9.9) -> torch.Tensor:
    """The inverse map, the mask first clipped to +-``limit``."""
    mask = mask.clamp(-limit, limit)
    return -K * torch.log((K - mask) / (K + mask))
