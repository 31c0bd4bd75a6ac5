"""Loss dispatch (counterpart of ``main_loss`` in ``se_tpu/losses/dispatch.py``)."""

from __future__ import annotations

import torch

from .core import mse, sdr, si_sdr, si_snr


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
