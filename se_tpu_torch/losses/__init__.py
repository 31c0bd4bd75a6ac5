from .core import l2_norm, mse, remove_dc, sdr, sdr_linear, si_sdr, si_snr
from .dispatch import main_loss, perceptual_loss

__all__ = ["l2_norm", "main_loss", "mse", "perceptual_loss", "remove_dc", "sdr", "sdr_linear",
           "si_sdr", "si_snr"]
