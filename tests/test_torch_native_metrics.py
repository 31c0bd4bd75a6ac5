"""The PyTorch port's native metrics (its own build of the P.862.2 PESQ and
the composite measures, ``se_tpu_torch/csrc/host/``), its profiling hooks
and its data statistics, against the JAX package's on the CPU."""

import json
import os

import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from se_tpu.eval import pesq_native as jpesq_native
from se_tpu.eval.composite import composite_measures as jcomposite_measures
from se_tpu.eval.pesq_np import pesq_wb_np
from se_tpu.utils.stats import get_mu_sig as jget_mu_sig

from se_tpu_torch.eval import pesq_native
from se_tpu_torch.eval.composite import composite_measures
from se_tpu_torch.obs.profiling import StepTimer, device_trace
from se_tpu_torch.ops import compile as host_compile
from se_tpu_torch.utils.stats import get_mu_sig

FS = 16000


def _speechlike(seed: int, seconds: float = 3.0) -> np.ndarray:
    """Formant-filtered pulses and noise under a syllable-rate envelope with
    pauses: active and silent stretches, as P.862's alignment expects."""
    rng = np.random.default_rng(seed)
    n = int(seconds * FS)
    t = np.arange(n) / FS
    f0 = 120 + 20 * np.sin(2 * np.pi * 0.7 * t)
    pulses = np.sin(2 * np.pi * np.cumsum(f0) / FS) ** 15
    src = pulses + 0.1 * rng.standard_normal(n)
    voiced = lfilter([1.0], [1.0, -1.3, 0.8], src)
    envelope = np.clip(np.sin(2 * np.pi * 3.0 * t), 0, None) * (np.sin(2 * np.pi * 0.4 * t) > -0.3)
    x = voiced * envelope
    return 0.3 * x / np.abs(x).max()


def _at_snr(x: np.ndarray, snr: float, seed: int) -> np.ndarray:
    noise = np.random.default_rng(seed).standard_normal(len(x))
    return x + noise * np.sqrt(np.mean(x**2) / np.mean(noise**2) * 10 ** (-snr / 10))


@pytest.mark.parametrize("snr", [30, 10])
def test_native_pesq_is_the_numpy_spec_and_the_jax_packages(snr):
    """Within 2e-3 of the JAX package's numpy P.862.2 (its own bound for its
    native build, ``tests/test_native_metrics.py``) and within 1e-9 of its
    native library, built from the same sources with the same flags."""
    x = _speechlike(11)
    y = _at_snr(x, snr, seed=12)
    got = pesq_native.pesq(x, y, FS)
    assert abs(got - pesq_wb_np(x, y)) <= 2e-3
    assert abs(got - jpesq_native.pesq(x, y, FS)) <= 1e-9
    assert 1.0 <= got <= 4.64


def test_identical_signals_score_the_maximum():
    x = _speechlike(5)
    assert abs(pesq_native.pesq(x, x, FS) - 4.6439) < 1e-3


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_composite_measures_are_the_jax_packages(native):
    """CSIG, CBAK, COVL and segSNR of a noisy copy: the port's native form
    within 1e-9 of the JAX package's native one, its numpy form equal to
    the JAX package's numpy one, and the two forms within 1e-6."""
    rng = np.random.default_rng(13)
    x = _speechlike(13)
    y = x + 0.02 * rng.standard_normal(len(x))
    got = np.array(composite_measures(x, y, FS, native=native))
    want = np.array(jcomposite_measures(x, y, FS, prefer_native=native))
    if native:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
        np.testing.assert_allclose(got, composite_measures(x, y, FS, native=False), atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and 1.0 <= got[0] <= 5.0


def test_library_builds_from_the_ports_sources_and_a_failed_build_raises(tmp_path, monkeypatch):
    """The library is built into ``build/host/`` from ``csrc/host/`` (the
    name carries a digest of the sources, headers and flags); with a
    compiler that fails, a fresh build raises instead of scoring another
    way."""
    path = host_compile.host_library_path("se_metrics", pesq_native.SOURCES)
    pesq_native.load()
    assert path.exists() and path.parent.name == "host"
    assert all((host_compile.HOST_SRC_DIR / f).exists() for f in pesq_native.SOURCES)
    monkeypatch.setattr(host_compile, "HOST_BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="host library build failed"):
        pesq_native.pesq(np.zeros(FS), np.zeros(FS), FS)
    assert list(tmp_path.iterdir()) == []


def test_step_timer_and_device_trace(tmp_path):
    """``StepTimer`` keeps the last and mean time of its blocks;
    ``device_trace`` writes a Chrome trace of the enclosed ops."""
    timer = StepTimer()
    for _ in range(3):
        with timer:
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert timer.n == 3 and 0 < timer.last <= timer.total and timer.mean == timer.total / 3
    with device_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    (trace,) = tmp_path.iterdir()
    assert trace.name == f"trace_{os.getpid()}.json"
    assert json.loads(trace.read_text())["traceEvents"]


def test_mu_sig_is_the_jax_packages():
    """Per-utterance means and deviations in float16, sigma below 1e-5 set
    to 1, bit for bit the JAX package's."""
    rng = np.random.default_rng(0)
    data = [rng.standard_normal((50, 6)), np.ones((20, 6)), rng.standard_normal((7, 6)) * 3]
    got, want = get_mu_sig(data), jget_mu_sig(data)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == np.float16
            np.testing.assert_array_equal(a, b)
    assert (got[1][1] == 1.0).all()
