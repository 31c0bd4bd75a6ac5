from .core import mse, sdr, si_sdr, si_snr
from .dispatch import main_loss

__all__ = ["main_loss", "mse", "sdr", "si_sdr", "si_snr"]
