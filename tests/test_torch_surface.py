"""The port's product surface against the JAX package's on the CPU: offline
corpus synthesis (``data/synth.py``) and its corpus builder
(``data/make_synth_corpus.py``), the named configurations, ``remove_dc``
and ``sdr_linear``, and the two examples at a tiny size.

The synthesis runs both packages in one wav tree made from a numpy seed:
three clean files (one at 8 kHz, so it is resampled; one shorter than every
noise file, one longer, so its noise is tiled) and two noise files.  The
JAX outputs are moved aside before the port writes its own, so that the
paths in the two logs agree; files and logs are compared byte for byte."""

import ctypes
import importlib
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from se_tpu import config as jconfig
from se_tpu.data import synth as jsynth
from se_tpu.dsp.stft import _frame as jframe
from se_tpu.losses import core as jcore

import se_tpu_torch
from se_tpu_torch import config
from se_tpu_torch.data import make_synth_corpus, synth
from se_tpu_torch.examples import streaming_demo, tutorial
from se_tpu_torch.losses import remove_dc, sdr_linear

FS = 16000
TRAIN_SNRS = [0.0, 5.0]
VALID_SNRS = [0.0, 5.0, 10.0]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run gives each of its workers a share of the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tree(tmp_path):
    """``{root}/{train,valid}/clean`` (the same three files) and
    ``{root}/train/noise``: clean files of 0.2 s and 0.8 s at 16 kHz and
    0.4 s at 8 kHz; noise files of 0.3 s and 0.5 s."""
    rng = np.random.default_rng(7)
    root = tmp_path / "corpus"
    for mode in ("train", "valid"):
        (root / mode / "clean").mkdir(parents=True)
    (root / "train" / "noise").mkdir()
    for name, seconds, fs in (("a_short", 0.2, FS), ("b_long", 0.8, FS), ("c_8k", 0.4, 8000)):
        t = np.arange(int(seconds * fs)) / fs
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(150, 300) * t) * (0.6 + 0.4 * np.sin(8 * t))
        for mode in ("train", "valid"):
            synth.write_wav(str(root / mode / "clean" / f"{name}.wav"), x, fs)
    for name, seconds in (("hum", 0.3), ("hiss", 0.5)):
        synth.write_wav(str(root / "train" / "noise" / f"{name}.wav"),
                        0.1 * rng.standard_normal(int(seconds * FS)), FS)
    return root


def _set_aside(root, mode, tag):
    """Move ``mode``'s noisy tree and log aside under ``tag`` -> their new paths."""
    noisy, log = root / mode / f"noisy_{tag}", root / mode / f"log_{tag}.tsv"
    (root / mode / "noisy").rename(noisy)
    (root / mode / "log.tsv").rename(log)
    return noisy, log


def _same_tree(root, mode, jnoisy, jlog):
    """The JAX package's outputs (set aside at ``jnoisy``, ``jlog``) and the
    port's: the same logs and the same files, byte for byte."""
    pnoisy, plog = _set_aside(root, mode, "port")
    assert plog.read_bytes() == jlog.read_bytes()
    names = sorted(os.listdir(jnoisy))
    assert sorted(os.listdir(pnoisy)) == names and names
    for name in names:
        assert (pnoisy / name).read_bytes() == (jnoisy / name).read_bytes(), name
    return jlog.read_text().splitlines()


@pytest.mark.parametrize("mode, snrs", [("train", TRAIN_SNRS), ("valid", VALID_SNRS)])
def test_generate_corpus_writes_the_jax_files(tree, mode, snrs):
    """Both packages' ``generate_corpus`` on one tree and seed write the same
    noisy wavs and ``log.tsv``, byte for byte: train mode every clean file at
    every SNR (names with the noise file's stem), valid mode one SNR a file;
    the 8-kHz file is read at 16 kHz, the 0.8-s one mixed with tiled noise."""
    log = jsynth.generate_corpus(mode, snrs, FS, root=str(tree), seed=3)
    jax_out = _set_aside(tree, mode, "jax")
    assert synth.generate_corpus(mode, snrs, FS, root=str(tree), seed=3) == log
    assert log == str(tree / mode / "log.tsv")
    lines = _same_tree(tree, mode, *jax_out)
    assert len(lines) == 3 * (len(snrs) if mode == "train" else 1)
    clean, noise, snr, name = lines[0].split("\t")
    assert clean == str(tree / mode / "clean" / "a_short.wav")
    assert float(snr) in snrs and name.endswith(f"_{snr}dB.wav")
    # train: a_short_<noise stem>_<snr>dB.wav; valid: a_short_<snr>dB.wav
    assert (os.path.splitext(os.path.basename(noise))[0] in name) == (mode == "train")


def test_pack_corpus_and_both_cli_forms_match_jax(tree, tmp_path, monkeypatch):
    """``pack_corpus`` (0.5 s: the short file padded, the long one cropped)
    gives equal arrays in both packages; so do both CLI forms (``[mode]
    [snr_csv] [fs]`` in the working directory, then ``pack``); an empty log
    raises the same ``ValueError`` in both."""
    for mode, snrs in (("train", TRAIN_SNRS), ("valid", VALID_SNRS)):
        synth.generate_corpus(mode, snrs, FS, root=str(tree), seed=5)
        got = np.load(synth.pack_corpus(mode, str(tmp_path / f"p_{mode}.npy"), 0.5, FS,
                                        root=str(tree)))
        want = np.load(jsynth.pack_corpus(mode, str(tmp_path / f"j_{mode}.npy"), 0.5, FS,
                                          root=str(tree)))
        assert got.dtype == np.float32 and got.shape == want.shape == (len(want), 2, 8000)
        np.testing.assert_array_equal(got, want)
        assert not got[0, :, 3200:].any()  # a_short: 0.2 s, then zeros

    monkeypatch.chdir(tree)
    for tag, cli in (("jax", jsynth.main), ("port", synth.main)):
        cli(["valid", "0,10", "16000"])
        cli(["pack", "valid", f"cli_{tag}.npy", "0.25", "16000"])
        if tag == "jax":
            _set_aside(tree, "valid", "cli_jax")
    np.testing.assert_array_equal(np.load(tree / "cli_port.npy"), np.load(tree / "cli_jax.npy"))
    assert np.load(tree / "cli_port.npy").shape == (3, 2, 4000)

    (tmp_path / "empty" / "train").mkdir(parents=True)
    (tmp_path / "empty" / "train" / "log.tsv").write_text("")
    errors = []
    for pack in (jsynth.pack_corpus, synth.pack_corpus):
        with pytest.raises(ValueError) as e:
            pack("train", str(tmp_path / "none.npy"), root=str(tmp_path / "empty"))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "no entries" in errors[0]


class _NoOracle:
    """Stands in for the ITU oracle binary that ``tools/pesq_oracle_battery``
    loads at import; ``speechlike``, all the corpus tool takes from it, does
    not call it."""

    def __init__(self, *args, **kwargs):
        self.pesq = types.SimpleNamespace()


def test_corpus_builder_matches_the_jax_tool(tmp_path, monkeypatch):
    """``make_synth_corpus`` at ``1 1 1`` (8 noise files of 10 s, one clean
    file a mode, mixed and packed) writes the same ``train``, ``valid`` and
    ``test`` arrays as ``tools/make_synth_corpus.py``."""
    monkeypatch.setattr(ctypes, "CDLL", _NoOracle)
    jtool = importlib.import_module("tools.make_synth_corpus")
    monkeypatch.setattr("sys.argv", ["make_synth_corpus.py", str(tmp_path / "jax"), "1", "1", "1"])
    jtool.main()
    make_synth_corpus.main([str(tmp_path / "port"), "1", "1", "1"])
    for mode, n in (("train", 2), ("valid", 1), ("test", 1)):
        got, want = (np.load(tmp_path / d / f"{mode}.npy") for d in ("port", "jax"))
        assert got.shape == (n, 2, 48000) and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
    assert len(os.listdir(tmp_path / "port" / "train" / "noise")) == 8


def _shared_fields(got, want, path=""):
    """``{path: (port value, JAX value)}`` over the fields both dataclasses
    have, nested dataclasses field by field."""
    out = {}
    for name in got.__dataclass_fields__:
        if name not in want.__dataclass_fields__:
            continue
        a, b = getattr(got, name), getattr(want, name)
        if hasattr(a, "__dataclass_fields__"):
            out.update(_shared_fields(a, b, f"{path}{name}."))
        else:
            out[path + name] = (a, b)
    return out


@pytest.mark.parametrize("name", ["tutorial_config", "default_config"])
def test_named_configs_match_jax(name):
    """Every field the two packages share, ``obs`` included, has the JAX
    package's value; both are exported from the package as in ``se_tpu``."""
    got = getattr(config, name)()
    fields = _shared_fields(got, getattr(jconfig, name)())
    assert {"model", "loss", "lstm", "masking_mode", "obs.log_media_every",
            "crn.rnn_units", "train.batch"} <= fields.keys()
    assert {k: v for k, v in fields.items() if v[0] != v[1]} == {}
    assert getattr(se_tpu_torch, name) is getattr(config, name)
    assert got.obs == config.ObsConfig(log_media_every=10)


def test_remove_dc_and_sdr_linear_match_jax():
    """f32, rtol 1e-6; ``remove_dc`` also atol 1e-8, an f32 ulp at the
    signals' scale (0.1): the two packages sum the mean in another order,
    and the difference of a sample near the mean has no relative bound."""
    rng = np.random.default_rng(11)
    s1 = (rng.standard_normal((3, 800)) * 0.1 + 0.02).astype(np.float32)
    s2 = (s1 + rng.standard_normal((3, 800)) * 0.05).astype(np.float32)
    t1, t2 = torch.from_numpy(s1), torch.from_numpy(s2)
    np.testing.assert_allclose(remove_dc(t1).numpy(), np.asarray(jcore.remove_dc(jnp.asarray(s1))),
                               rtol=1e-6, atol=1e-8)
    got = sdr_linear(t1, t2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(jcore.sdr_linear(jnp.asarray(s1),
                                                                   jnp.asarray(s2))), rtol=1e-6)


def test_tutorial_trains_on_the_cpu(tmp_path):
    """The tutorial at 4 training and 2 validation utterances of 0.5 s, one
    epoch at batch 2, scored by the native PESQ and STOI: finite validation
    losses and the run directory."""
    mse = tutorial.main(["--device", "cpu", "--n-train", "4", "--n-valid", "2", "--epochs", "1",
                         "--seconds", "0.5", "--batch", "2", "--job-dir",
                         str(tmp_path / "models"), "--logs-dir", str(tmp_path / "logs")])
    assert mse.shape == (1,) and np.isfinite(mse).all()
    (run,) = (tmp_path / "models").iterdir()
    assert run.name.endswith("_CRN_MSE")
    assert {"log.txt", "chkpt_1.pt", "Epoch_1_SCORES"} <= set(os.listdir(run))


def _jax_demo_samples(length, chunk, cfg):
    """The samples the JAX demo emits for ``length`` samples in chunks of
    ``chunk``: each chunk frames ``[the last win - hop samples || chunk]``
    (``se_tpu.dsp.stft._frame``) and emits a hop a frame; the flush emits
    ``win - hop``."""
    win, hop = cfg.stft.win_len, cfg.stft.win_inc
    frames = sum(jframe(jnp.zeros((1, win - hop + min(chunk, length - s))), win, hop).shape[1]
                 for s in range(0, length, chunk))
    return frames * hop + win - hop


@pytest.mark.parametrize("seconds", [0.2, 0.23])
def test_streaming_demo_emits_the_jax_demos_samples(seconds):
    """0.2 s in 50-ms chunks (four whole ones) and 0.23 s (a ragged last
    chunk of 480 samples): as many samples as the JAX demo's framing gives."""
    n = streaming_demo.main(["--device", "cpu", "--seconds", str(seconds), "--chunk-ms", "50"])
    assert n == _jax_demo_samples(int(round(seconds * FS)), 800, config.Config())


def test_examples_default_to_cuda(tmp_path):
    """Without a card both examples raise before any work: no quiet fallback."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        streaming_demo.main(["--seconds", "0.1"])
    with pytest.raises(RuntimeError, match="cuda"):
        tutorial.main(["--n-train", "2", "--n-valid", "1", "--job-dir", str(tmp_path)])
