"""The PyTorch port's tensorboard writer and image helpers on the CPU, against
the JAX package's: the same calls write the same scalars, audio and images,
the mask channel's too; and the training loop's media cadence
(``ObsConfig.log_media_every``) on a tiny CRN.  Skipped where tensorboardX
is not installed (the writer then writes nothing, which a test checks with
tensorboardX hidden)."""

import os
import struct

import numpy as np
import pytest

pytest.importorskip("tensorboardX")

from se_tpu.obs import Writer as JWriter  # noqa: E402
from se_tpu.obs.plots import plot_error_to_numpy as jplot_error  # noqa: E402
from se_tpu.obs.plots import plot_mask_to_numpy as jplot_mask  # noqa: E402
from se_tpu.obs.plots import plot_spectrogram_to_numpy as jplot_spectrogram  # noqa: E402

from se_tpu_torch.config import (  # noqa: E402
    Config,
    CrnConfig,
    DccrnConfig,
    ObsConfig,
    TrainConfig,
)
from se_tpu_torch.obs import writer as writer_mod  # noqa: E402
from se_tpu_torch.obs.plots import (  # noqa: E402
    plot_error_to_numpy,
    plot_mask_to_numpy,
    plot_spectrogram_to_numpy,
)
from se_tpu_torch.train.loop import Trainer  # noqa: E402

IMAGES = ("spec_noisy", "spec_clean", "spec_enhanced", "phase_clean", "phase_enhanced",
          "spec_error")
AUDIO = ("noisy_target_wav", "clean_target_wav", "enhanced_wav")
MASKS = ("mask_mag", "mask_real", "mask_imag")


def _summaries(logdir) -> dict:
    """``{(tag, step): summary value}`` of every event file under ``logdir``,
    read as the TFRecord frames tensorboard writes: a little-endian u64
    length, its CRC, the Event proto, its CRC."""
    from tensorboardX.proto.event_pb2 import Event

    out = {}
    for name in os.listdir(logdir):
        data = open(os.path.join(logdir, name), "rb").read()
        i = 0
        while i < len(data):
            (n,) = struct.unpack("<Q", data[i : i + 8])
            ev = Event()
            ev.ParseFromString(data[i + 12 : i + 12 + n])
            i += 12 + n + 4
            for v in ev.summary.value:
                out[(v.tag, ev.step)] = v
    return out


def _write(writer_cls, logdir, wavs):
    w = writer_cls(str(logdir))
    w.log_loss(0.5, 0.625, 1)
    w.log_sub_loss(0.25, 0.125, 0.375, 0.0625, 1)
    w.log_score(2.5, 0.875, 1)
    w.log_wav(*wavs, 10)
    w.log_spectrogram(*wavs, 10)
    w.close()
    return _summaries(logdir)


def _wavs(rng, n=16000):
    clean = (0.3 * np.sin(2 * np.pi * 440 * np.arange(n) / 16000)).astype(np.float32)
    noisy = clean + 0.05 * rng.standard_normal(n).astype(np.float32)
    return noisy, clean, 0.5 * (noisy + clean)


def test_writer_logs_what_the_jax_writer_logs(tmp_path, rng):
    """Scalars (the perceptual variant's two terms too) to the float32 bit,
    audio and images byte for byte."""
    wavs = _wavs(rng)
    got = _write(writer_mod.Writer, tmp_path / "port", wavs)
    want = _write(JWriter, tmp_path / "jax", wavs)
    assert set(got) == set(want)
    sub = ("train_main_loss", "train_perceptual_loss", "vali_main_loss", "vali_perceptual_loss")
    assert {(k, 1) for k in ("train_loss", "vali_loss", "PESQ", "STOI", *sub)} <= set(got)
    assert {(t, 10) for t in AUDIO + IMAGES} <= set(got)
    for key in ("train_loss", "vali_loss", "PESQ", "STOI", *sub):
        assert got[(key, 1)].simple_value == want[(key, 1)].simple_value
    assert got[("vali_loss", 1)].simple_value == 0.625
    for tag in AUDIO:
        a = got[(tag, 10)].audio
        assert a.sample_rate == 16000 and a.length_frames == 16000
        assert a.encoded_audio_string == want[(tag, 10)].audio.encoded_audio_string
    for tag in IMAGES:
        im = got[(tag, 10)].image
        assert im.height > 0 and im.width > 0 and im.colorspace == 3
        assert im.encoded_image_string == want[(tag, 10)].image.encoded_image_string


def test_image_helpers_equal_the_jax_package(rng):
    """Exact: both draw with matplotlib's Agg backend from the same code."""
    noisy, clean, est = _wavs(rng, 8000)
    for mode, clim in ((None, (-150, 0)), ("phase", (-np.pi, np.pi))):
        got = plot_spectrogram_to_numpy(clean, 16000, 512, 100, mode, clim)
        assert got.ndim == 3 and got.shape[2] == 3 and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jplot_spectrogram(clean, 16000, 512, 100, mode, clim))
    np.testing.assert_array_equal(plot_error_to_numpy(est, clean, 16000, 512, 100),
                                  jplot_error(est, clean, 16000, 512, 100))


def _masks(rng, T=40, F=33):
    """Magnitude, real and imaginary masks ``[T, F]``, partly outside the
    channel's colour limits."""
    mag = rng.uniform(0.0, 1.5, (T, F)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (T, F))
    return mag, (mag * np.cos(phase)).astype(np.float32), (mag * np.sin(phase)).astype(np.float32)


def test_mask_image_equals_the_jax_package(rng):
    """Exact, with and without colour limits."""
    mag, real, _ = _masks(rng)
    for m, clim in ((mag, (0, 1.2)), (real, (-1.2, 1.2)), (real, (None, None))):
        got = plot_mask_to_numpy(m, 16000, 512, 100, *clim)
        assert got.ndim == 3 and got.shape[2] == 3 and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jplot_mask(m, 16000, 512, 100, *clim))


def test_mask_channel_logs_what_the_jax_writer_logs(tmp_path, rng):
    """``log_mask_spectrogram`` writes the three mask images of the JAX
    writer, byte for byte, and nothing else."""
    masks = _masks(rng)
    got, want = {}, {}
    for cls, logdir, out in ((writer_mod.Writer, tmp_path / "port", got),
                             (JWriter, tmp_path / "jax", want)):
        w = cls(str(logdir))
        w.log_mask_spectrogram(*masks, 10)
        w.close()
        out.update(_summaries(logdir))
    assert set(got) == set(want) == {(t, 10) for t in MASKS}
    for key in got:
        im = got[key].image
        assert im.height > 0 and im.width > 0 and im.colorspace == 3
        assert im.encoded_image_string == want[key].image.encoded_image_string


def test_writer_without_tensorboardx_writes_nothing(tmp_path, rng, monkeypatch):
    monkeypatch.setattr(writer_mod, "_HAS_TB", False)
    wavs = _wavs(rng, 4000)
    w = writer_mod.Writer(str(tmp_path))
    w.log_loss(0.5, 0.6, 1)
    w.log_score(2.5, 0.85, 1)
    w.log_wav(*wavs, 10)
    w.log_spectrogram(*wavs, 10)
    w.log_mask_spectrogram(*_masks(rng), 10)
    w.close()
    assert os.listdir(tmp_path) == []


def _fake_scores(est, clean):
    return [1.0] * len(est), [0.5] * len(est)


class _MediaLog:
    """Records the epochs the loop logs audio and spectrograms on."""

    def __init__(self):
        self.calls = []

    def log_wav(self, noisy, clean, est, step):
        self.calls.append(("wav", step))

    def log_spectrogram(self, noisy, clean, est, step):
        self.calls.append(("spectrogram", step))


def test_media_cadence_follows_obs_config(tmp_path):
    """The port's loop on a tiny CRN.  One epoch at ``log_media_every=1``
    writes the audio and the spectrogram images beside the scalars.  Then
    its validation at epochs 1-20 under 0, 1 and the default 10 logs both
    channels on exactly the epochs of the JAX loop's rule, ``every > 0 and
    epoch % every == 0`` (``se_tpu/train/loop.py:305-306``): the default's
    calls, so its tags, are those of the hard-coded 10 before
    ``ObsConfig``."""
    rng = np.random.default_rng(3)
    clean = (rng.standard_normal((4, 4000)) * 0.1).astype(np.float32)
    data = np.stack([clean + (rng.standard_normal(clean.shape) * 0.05).astype(np.float32),
                     clean], 1)
    cfg = Config(model="CRN", loss="MSE", lstm="real", dccrn=DccrnConfig(kernel_num=(8, 16, 16)),
                 crn=CrnConfig(rnn_input_size=256, rnn_units=32),
                 train=TrainConfig(max_epochs=1, batch=2, job_dir=str(tmp_path / "models"),
                                   logs_dir=str(tmp_path / "logs")),
                 obs=ObsConfig(log_media_every=1))
    assert Config().obs.log_media_every == 10
    t = Trainer(cfg, data, data[:3], score_fn=_fake_scores, device="cpu")
    t.setup()
    t.run()
    logged = _summaries(t.dir_to_logs)
    scalars = {(k, 1) for k in ("train_loss", "vali_loss", "PESQ", "STOI")}
    assert set(logged) == scalars | {(tag, 1) for tag in AUDIO + IMAGES}

    epochs = range(1, 21)
    for every in (0, 1, 10):
        t.cfg = cfg.replace(obs=ObsConfig(log_media_every=every))
        t.writer = _MediaLog()
        for e in epochs:
            t.validate_epoch(e)
        want = [(kind, e) for e in epochs if every > 0 and e % every == 0
                for kind in ("wav", "spectrogram")]
        assert t.writer.calls == want, every
