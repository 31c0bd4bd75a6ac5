"""Loss dispatch (counterpart of ``se_tpu/losses/dispatch.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from .core import mse, sdr, si_sdr, si_snr
from .lms import lms_loss
from .pmsqe import pmsqe_loss


def main_loss(loss_name: str, estimated: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The training objective to minimise; argument orders as the reference's."""
    if loss_name == "MSE":
        return mse(estimated, target)
    if loss_name == "SDR":
        return -sdr(target, estimated)
    if loss_name == "SI-SNR":
        return -si_snr(estimated, target)
    if loss_name == "SI-SDR":
        return -si_sdr(target, estimated)
    raise ValueError(f"unknown loss {loss_name!r}")


def perceptual_loss(
    perceptual_name: str,
    target_wav: torch.Tensor,
    estimated_wav: torch.Tensor,
    clean_mags: Optional[torch.Tensor] = None,
    est_mags: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """LMS on the magnitude spectrograms ``[B, F, T]``, or PMSQE on the
    waveforms ``[B, L]``."""
    if perceptual_name == "LMS":
        if clean_mags is None or est_mags is None:
            raise ValueError("LMS takes the clean and the estimated magnitudes")
        return lms_loss(clean_mags, est_mags)
    if perceptual_name == "PMSQE":
        return pmsqe_loss(target_wav, estimated_wav)
    raise ValueError(f"unknown perceptual loss {perceptual_name!r}")
