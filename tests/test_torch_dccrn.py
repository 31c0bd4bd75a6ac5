"""The PyTorch port's DCCRN slice (se_tpu_torch) against the JAX package on
the CPU at a tiny width: the whole forward for each mask, the eval step,
the weight carry-over and the enhance CLI.

The JAX weights are a numpy tree (``random_dccrn_params``) handed to
flax's ``apply`` directly: its layout is checked against flax's own
``init`` structure, which avoids running the ~12 s ``init``."""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from se_tpu.config import Config as JConfig, DccrnConfig as JDccrnConfig
from se_tpu.models import build_model as jbuild_model
from se_tpu.train.steps import eval_step_body
from se_tpu.utils.torch_export import export_reference_state_dict, save_reference_checkpoint

from se_tpu_torch.config import Config, DccrnConfig
from se_tpu_torch.data.wav import read_wav, write_wav
from se_tpu_torch.enhance import main as enhance_main
from se_tpu_torch.models import build_model
from se_tpu_torch.train.steps import eval_step
from se_tpu_torch.utils.weights import (
    dccrn_state_dict_from_jax,
    load_reference_checkpoint,
    random_dccrn_params,
    save_reference_checkpoint as tsave,
)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(kernel_num=(8, 16, 16), rnn_units=32)


def _cfgs(mode="E"):
    return (JConfig(masking_mode=mode, dccrn=JDccrnConfig(**TINY)),
            Config(masking_mode=mode, dccrn=DccrnConfig(**TINY)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run gives each of its workers a share of the cores; torch's
    default pool of one thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    _, cfg = _cfgs()
    params, bstats = random_dccrn_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    clean = (rng.standard_normal((2, 4000)) * 0.1).astype(np.float32)
    noisy = (clean + rng.standard_normal((2, 4000)) * 0.05).astype(np.float32)
    return types.SimpleNamespace(params=params, bstats=bstats, noisy=noisy, clean=clean)


def _port(mode, tiny):
    jcfg, cfg = _cfgs(mode)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(dccrn_state_dict_from_jax(tiny.params, tiny.bstats, cfg), strict=True)
    return jcfg, cfg, model


def test_random_tree_has_flax_layout(tiny):
    jcfg, _ = _cfgs()
    shapes = jax.eval_shape(
        lambda: jbuild_model(jcfg).init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4000)), train=False
        )
    )
    want = jax.tree.map(lambda s: s.shape, dict(shapes))
    got = jax.tree.map(np.shape, {"params": tiny.params, "batch_stats": tiny.bstats})
    assert got == want


@pytest.mark.parametrize("mode", ["E", "C", "R"])
def test_dccrn_forward_matches_jax(mode, tiny):
    """out_real, out_imag and out_wav at atol 1e-4: f32 through three conv
    stages, two LSTM layers and three transposed convs."""
    jcfg, _, model = _port(mode, tiny)
    want = jbuild_model(jcfg).apply(
        {"params": tiny.params, "batch_stats": tiny.bstats}, jnp.asarray(tiny.noisy), train=False
    )
    with torch.inference_mode():
        got = model(torch.from_numpy(tiny.noisy))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_eval_step_matches_jax(tiny):
    """SDR loss at rtol 1e-4; enhanced waveforms at atol 1e-4."""
    jcfg, cfg, model = _port("E", tiny)
    state = types.SimpleNamespace(params=tiny.params, batch_stats=tiny.bstats)
    want_m, want_wav = eval_step_body(jcfg, jbuild_model(jcfg))(
        state, jnp.asarray(tiny.noisy), jnp.asarray(tiny.clean)
    )
    got_m, got_wav = eval_step(cfg, model, tiny.noisy, tiny.clean)
    np.testing.assert_allclose(got_m["loss"].item(), float(want_m["loss"]), rtol=1e-4)
    np.testing.assert_allclose(got_wav.numpy(), np.asarray(want_wav), atol=1e-4)


def test_state_dict_equals_jax_export(tiny):
    """Key for key and value for value, then a strict load."""
    jcfg, cfg = _cfgs()
    want = export_reference_state_dict(tiny.params, tiny.bstats, jcfg)
    got = dccrn_state_dict_from_jax(tiny.params, tiny.bstats, cfg)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    build_model(cfg, device="cpu").load_state_dict(got, strict=True)


def test_jax_checkpoint_blob_loads_into_port(tiny, tmp_path):
    """The blob the JAX exporter writes reaches the port unchanged."""
    jcfg, cfg = _cfgs()
    path = save_reference_checkpoint(str(tmp_path / "c.pt"), tiny.params, tiny.bstats, jcfg, 7)
    sd, epoch = load_reference_checkpoint(path)
    assert epoch == 7
    want = dccrn_state_dict_from_jax(tiny.params, tiny.bstats, cfg)
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in sd)


def test_enhance_cli_batch_matches_per_file(tmp_path):
    """``python -m se_tpu_torch.enhance --device cpu --batch 2`` on three
    wavs (two share a one-second bucket, one is shorter than a window)
    against the per-file run, within 2 int16 LSBs.  (``chip_smoke.py``
    holds the CLI against in-process ``enhance_batch`` on the card.)"""
    cfg = Config()
    ckpt = tsave(str(tmp_path / "c.pt"),
                 dccrn_state_dict_from_jax(*random_dccrn_params(cfg, seed=1), cfg))
    rng = np.random.default_rng(2)
    wavs = {}
    for name, L in (("a.wav", 4000), ("b.wav", 7100), ("c.wav", 300)):
        write_wav(str(tmp_path / name), rng.standard_normal(L) * 0.1, cfg.stft.fs)
        wavs[name] = read_wav(str(tmp_path / name))[0].astype(np.float32)
    paths = [str(tmp_path / n) for n in wavs]
    common = ["--checkpoint", ckpt, "--model", "DCCRN", "--device", "cpu"]

    enhance_main([*common, *paths, "--out-dir", str(tmp_path / "single")])
    r = subprocess.run(
        [sys.executable, "-m", "se_tpu_torch.enhance", *common, "--batch", "2", *paths,
         "--out-dir", str(tmp_path / "batch")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert r.returncode == 0, r.stderr[-2000:]

    for name, wav in wavs.items():
        single = read_wav(str(tmp_path / "single" / name))[0]
        batch = read_wav(str(tmp_path / "batch" / name))[0]
        L = len(wav)
        assert len(single) == len(batch) == (L if L > 400 else L // 100 * 100)
        np.testing.assert_allclose(batch, single, atol=2 / 32768)
