"""Time-domain objectives (counterpart of ``se_tpu/losses/core.py``),
including the reference's non-standard ``sdr``, whose "norms" are dot
products and which squares numerator and denominator."""

from __future__ import annotations

import torch


def remove_dc(data: torch.Tensor) -> torch.Tensor:
    """``data`` less its mean along the last axis."""
    return data - torch.mean(data, dim=-1, keepdim=True)


def l2_norm(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Inner product along the last axis, dim kept (a reference quirk:
    not a norm)."""
    return torch.sum(s1 * s2, dim=-1, keepdim=True)


def sdr_linear(s1: torch.Tensor, s2: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``<s1,s1>^2 / <s1-s2, s1-s2>^2``, averaged: :func:`sdr` before its log."""
    sn = l2_norm(s1, s1)
    sn_m_shn = l2_norm(s1 - s2, s1 - s2)
    return torch.mean(sn**2 / (sn_m_shn**2 + eps))


def sdr(s1: torch.Tensor, s2: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``10 log10(<s1,s1>^2 / <s1-s2, s1-s2>^2)``, averaged."""
    sn = l2_norm(s1, s1)
    sn_m_shn = l2_norm(s1 - s2, s1 - s2)
    return torch.mean(10 * torch.log10(sn**2 / (sn_m_shn**2 + eps)))


def si_snr(s1: torch.Tensor, s2: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Projection SI-SNR of ``s1`` on the reference ``s2``."""
    s_target = l2_norm(s1, s2) / (l2_norm(s2, s2) + eps) * s2
    e_noise = s1 - s_target
    snr = 10 * torch.log10(
        l2_norm(s_target, s_target) / (l2_norm(e_noise, e_noise) + eps) + eps
    )
    return torch.mean(snr)


def si_sdr(reference: torch.Tensor, estimation: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Optimal-scaling SI-SDR; the ratio is averaged before the log."""
    reference_energy = torch.sum(reference**2, dim=-1, keepdim=True)
    optimal_scaling = (
        torch.sum(reference * estimation, dim=-1, keepdim=True) / reference_energy + eps
    )
    projection = optimal_scaling * reference
    noise = estimation - projection
    ratio = torch.sum(projection**2, dim=-1) / torch.sum(noise**2, dim=-1) + eps
    return 10 * torch.log10(torch.mean(ratio) + eps)


def mse(estimated: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((estimated - target) ** 2)
