from .core import mse, sdr, si_sdr, si_snr
from .dispatch import main_loss, perceptual_loss

__all__ = ["main_loss", "mse", "perceptual_loss", "sdr", "si_sdr", "si_snr"]
