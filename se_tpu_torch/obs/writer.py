"""Tensorboard writer (counterpart of ``se_tpu/obs/writer.py``; reference:
write_on_tensorboard.py:13-386).

Scalars (train/val loss, the perceptual variant's two terms, PESQ/STOI),
periodic audio triplets, and the spectrogram and mask image channels.  The
validation loop logs the audio and the spectrograms every
``Config.obs.log_media_every`` epochs (default 10, the reference's
hard-coded audio cadence, trainer.py:232-233); as in the JAX package and
the reference, nothing in the loop draws the masks.
"""

from __future__ import annotations

import numpy as np

try:
    from tensorboardX import SummaryWriter

    _HAS_TB = True
except ImportError:
    SummaryWriter = object
    _HAS_TB = False


class Writer:
    """Writes nothing when ``tensorboardX`` is not importable.  The image
    channels import matplotlib (``obs/plots.py``) only when they draw, so the
    writer imports where matplotlib is absent."""

    def __init__(self, logdir: str, fs: int = 16000, n_fft: int = 512,
                 n_overlap: int = 100):
        self.fs, self.n_fft, self.n_overlap = fs, n_fft, n_overlap
        self._w = SummaryWriter(logdir) if _HAS_TB else None

    # -- scalars ----------------------------------------------------------
    def log_loss(self, train_loss, vali_loss, step):
        if self._w is None:
            return
        self._w.add_scalar("train_loss", float(train_loss), step)
        self._w.add_scalar("vali_loss", float(vali_loss), step)

    def log_sub_loss(self, train_main, train_perceptual, vali_main, vali_perceptual, step):
        """The perceptual variant's two terms, in training and validation."""
        if self._w is None:
            return
        self._w.add_scalar("train_main_loss", float(train_main), step)
        self._w.add_scalar("train_perceptual_loss", float(train_perceptual), step)
        self._w.add_scalar("vali_main_loss", float(vali_main), step)
        self._w.add_scalar("vali_perceptual_loss", float(vali_perceptual), step)

    def log_score(self, pesq, stoi, step):
        if self._w is None:
            return
        self._w.add_scalar("PESQ", float(pesq), step)
        self._w.add_scalar("STOI", float(stoi), step)

    # -- audio ------------------------------------------------------------
    def _encode_wav(self, wav: np.ndarray) -> bytes:
        """int16 WAV encoding via the stdlib (tensorboardX's own audio path
        needs the soundfile package, which this image does not ship)."""
        import io
        import wave as wave_mod

        buf = io.BytesIO()
        with wave_mod.open(buf, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(self.fs)
            pcm = np.clip(np.asarray(wav, np.float64), -1.0, 1.0)
            f.writeframes((pcm * 32767).astype("<i2").tobytes())
        return buf.getvalue()

    def log_wav(self, noisy_wav, clean_wav, enhanced_wav, step):
        """Audio triplet every N epochs (reference: write_on_tensorboard.py:332-336)."""
        if self._w is None:
            return
        from tensorboardX.proto.summary_pb2 import Summary

        for name, wav in (
            ("noisy_target_wav", noisy_wav),
            ("clean_target_wav", clean_wav),
            ("enhanced_wav", enhanced_wav),
        ):
            wav = np.asarray(wav).reshape(-1)
            audio = Summary.Audio(
                sample_rate=self.fs,
                num_channels=1,
                length_frames=len(wav),
                encoded_audio_string=self._encode_wav(wav),
                content_type="audio/wav",
            )
            self._w._get_file_writer().add_summary(
                Summary(value=[Summary.Value(tag=name, audio=audio)]), step
            )

    # -- images -----------------------------------------------------------
    def log_spectrogram(self, noisy_wav, clean_wav, enhanced_wav, step):
        """8-image channel: spectrogram/phase/error maps
        (reference: write_on_tensorboard.py:338-373)."""
        if self._w is None:
            return
        from .plots import plot_error_to_numpy, plot_spectrogram_to_numpy

        wavs = {
            "noisy": np.asarray(noisy_wav),
            "clean": np.asarray(clean_wav),
            "enhanced": np.asarray(enhanced_wav),
        }
        for name, wav in wavs.items():
            img = plot_spectrogram_to_numpy(
                wav, self.fs, self.n_fft, self.n_overlap, None, (-150, 0)
            )
            self._w.add_image(f"spec_{name}", img, step, dataformats="HWC")
        for name, wav in (("clean", wavs["clean"]), ("enhanced", wavs["enhanced"])):
            img = plot_spectrogram_to_numpy(
                wav, self.fs, self.n_fft, self.n_overlap, "phase", (-np.pi, np.pi)
            )
            self._w.add_image(f"phase_{name}", img, step, dataformats="HWC")
        err = plot_error_to_numpy(
            wavs["enhanced"], wavs["clean"], self.fs, self.n_fft, self.n_overlap
        )
        self._w.add_image("spec_error", err, step, dataformats="HWC")

    def log_mask_spectrogram(self, mask_mag, mask_real, mask_imag, step):
        """Mask images over ``[T, F]`` (reference: write_on_tensorboard.py:375-386)."""
        if self._w is None:
            return
        from .plots import plot_mask_to_numpy

        for name, m, clim in (
            ("mask_mag", mask_mag, (0, 1.2)),
            ("mask_real", mask_real, (-1.2, 1.2)),
            ("mask_imag", mask_imag, (-1.2, 1.2)),
        ):
            img = plot_mask_to_numpy(np.asarray(m), self.fs, self.n_fft, self.n_overlap, *clim)
            self._w.add_image(name, img, step, dataformats="HWC")

    def close(self):
        if self._w is not None:
            self._w.close()
