"""FullSubNet's optional pieces in the PyTorch port against the JAX package
on the CPU: the forgetting-EMA norms (``forgetting_norm``,
``sband_forgetting_norm``, ``hybrid_norm``), the band dropping
``reduce_complexity_separately``, ``weight_init=True``'s init table
(``apply_reference_weight_init``) for the LSTM and the GRU, and ten Adam
steps of a tiny FullSubNet against JAX's jitted ``make_train_step``
(settling whether the first step's loss rise is the reference's own)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from se_tpu import ops as jops
from se_tpu.models.factory import apply_reference_weight_init as japply_init
from se_tpu.ops.unfold import reduce_complexity_separately as jreduce

import se_tpu_torch.ops as tops
from se_tpu_torch.config import Config, FullSubNetConfig
from se_tpu_torch.models import build_model
from se_tpu_torch.models.factory import _TRUNCATED_STD
from se_tpu_torch.ops import norms
from se_tpu_torch.ops.unfold import reduce_complexity_separately
from se_tpu_torch.utils.weights import random_fullsubnet_params, state_dict_from_jax
from tests.torch_fsn_first_step import adam_losses

EMA_TOL = 1e-6  # relative, elementwise
ORTHO_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run gives each of its workers a share of the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the forgetting-EMA norms --------------------------------------------------


def _magnitudes(B, F, T, seed):
    """Positive ``[B, F, T]`` magnitudes with a slow envelope over frames."""
    rng = np.random.default_rng(seed)
    env = 1 + 0.5 * np.sin(np.linspace(0, 6, T))
    return (np.abs(rng.standard_normal((B, F, T))) * env + 0.01).astype(np.float32)


@pytest.mark.parametrize("name,length", [("forgetting_norm", 20), ("sband_forgetting_norm", 20),
                                         ("hybrid_norm", 20), ("hybrid_norm", None)])
def test_ema_norms_match_jax(name, length):
    """Each EMA norm on ``[2, 17, 200]`` equals the JAX package's within 1e-6
    relative, through the warm-up (alp_0 = -1: mu_0 = 2 stat_0; alp_1 = 0)
    and after it (``sample_length`` 20, or ``hybrid_norm``'s default 192,
    where it turns to the cumulative mean); the three are exported by
    ``se_tpu_torch.ops`` as by ``se_tpu.ops`` and kept out of
    ``norm_wrapper``'s table."""
    x = _magnitudes(2, 17, 200, seed=4)
    args = () if length is None else (length,)
    got = getattr(tops, name)(torch.from_numpy(x), *args).numpy()
    want = np.asarray(jax.jit(lambda v: getattr(jops, name)(v, *args))(jnp.asarray(x)))
    assert got.shape == want.shape == x.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=EMA_TOL, atol=0)
    assert getattr(tops, name) is getattr(norms, name)
    with pytest.raises(NotImplementedError):
        norms.norm_wrapper(name)


def test_ema_warm_up_quirk():
    """The first two frames of ``forgetting_norm``: mu_0 = 2 stat_0 (alp_0 =
    min(-1, alpha) = -1), mu_1 = stat_1 (alp_1 = 0); ``sband_forgetting_norm``
    takes bin F // 2 - 1 once its warm-up is over."""
    x = torch.from_numpy(_magnitudes(1, 9, 8, seed=5))
    mean = x.mean(dim=1)
    y = norms.forgetting_norm(x, 4)
    torch.testing.assert_close(y[:, :, 0], x[:, :, 0] / (2 * mean[:, None, 0] + 1e-10))
    torch.testing.assert_close(y[:, :, 1], x[:, :, 1] / (mean[:, None, 1] + 1e-10))
    # alp = -1, 0, 1/3, 1/2 in the warm-up (t < 4), then alpha = 3/5
    mu = 2 * mean[:, 0]
    for t, a in ((1, 0.0), (2, 1 / 3), (3, 1 / 2)):
        mu = a * mu + (1 - a) * mean[:, t]
    want = 3 / 5 * mu + 2 / 5 * x[:, 3, 4]  # frame 4: past the warm-up, bin 9 // 2 - 1
    torch.testing.assert_close(norms.sband_forgetting_norm(x, 4)[:, :, 4],
                               x[:, :, 4] / (want[:, None] + 1e-10))


# --- reduce_complexity_separately --------------------------------------------------


def test_reduce_complexity_separately_matches_jax_and_raises_where_it_fails():
    """At F = 257 the port's band dropping equals the JAX package's bit for
    bit (three sub-batches of 85 bins); at F = 9, where the reference's
    concatenation fails (3, 2 and 2 bins), it raises ValueError."""
    rng = np.random.default_rng(6)
    sb = rng.standard_normal((7, 257, 1, 31, 5)).astype(np.float32)
    fb = rng.standard_normal((7, 257, 1, 3, 5)).astype(np.float32)
    got = reduce_complexity_separately(torch.from_numpy(sb), torch.from_numpy(fb)).numpy()
    want = np.asarray(jreduce(jnp.asarray(sb), jnp.asarray(fb)))
    assert got.shape == want.shape == (6, 85, 1, 34, 5)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError):  # the reference itself
        jreduce(jnp.zeros((6, 9, 1, 3, 4)), jnp.zeros((6, 9, 1, 1, 4)))
    with pytest.raises(ValueError, match=r"\[3, 2, 2\]"):
        reduce_complexity_separately(torch.zeros(6, 9, 1, 3, 4), torch.zeros(6, 9, 1, 1, 4))


# --- weight_init ----------------------------------------------------------------------


def _cfg(seq, weight_init):
    return Config(model="FullSubNet", loss="MSE", sequence_model=seq,
                  fullsubnet=FullSubNetConfig(weight_init=weight_init))


@pytest.mark.parametrize("seq", ["LSTM", "GRU"])
def test_weight_init_matches_the_reference_table(seq):
    """``weight_init=True`` at full width changes the leaves that the JAX
    package's ``apply_reference_weight_init`` changes (mapped through
    ``state_dict_from_jax``) and no other; each RNN weight's smaller side is
    orthonormal within 1e-5; the Xavier leaves (``fc_output_layer.weight``)
    have Xavier's std and lie within JAX's truncation; the 1-D leaves are
    standard normal, within five standard errors; the same seed gives the
    same bits, another seed others."""
    cfg = _cfg(seq, True)
    params, _ = random_fullsubnet_params(cfg, seed=0)
    jnew = japply_init(jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(1))
    before = state_dict_from_jax(params, {}, cfg)
    after = state_dict_from_jax(jax.tree.map(np.asarray, jnew), {}, cfg)
    want = {k for k in before if not torch.equal(before[k], after[k])}

    plain = build_model(_cfg(seq, False), device="cpu", seed=0).state_dict()
    model = build_model(cfg, device="cpu", seed=0)
    sd = model.state_dict()
    assert sd.keys() == before.keys()
    assert {k for k in sd if not torch.equal(sd[k], plain[k])} == want

    ones = []
    for name, p in sd.items():
        if p.ndim == 1:
            ones.append(p)
        elif "weight_ih" in name or "weight_hh" in name:
            w = p.double()
            gram = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
            err = (gram - torch.eye(gram.shape[0], dtype=torch.float64)).abs().max().item()
            assert err <= ORTHO_TOL, (name, err)
        else:
            assert name.endswith("fc_output_layer.weight"), name
            std = np.sqrt(2 / sum(p.shape))
            bound = 2 * std / _TRUNCATED_STD
            assert p.abs().max().item() <= bound, name
            assert np.abs(np.asarray(jnew[name.split(".")[0]]["fc_output_layer"]["weight"])
                          ).max() <= bound * (1 + 1e-6)
            n = p.numel()
            assert abs(p.std().item() / std - 1) <= 5 / np.sqrt(2 * n), (name, p.std().item(), std)
    flat = torch.cat(ones)
    n = flat.numel()
    assert abs(flat.mean().item()) <= 5 / np.sqrt(n) and abs(flat.std().item() - 1) <= 5 / np.sqrt(2 * n)

    again = build_model(cfg, device="cpu", seed=0).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    other = build_model(cfg, device="cpu", seed=1).state_dict()
    assert all(not torch.equal(sd[k], other[k]) for k in want)


# --- ten Adam steps against JAX's --------------------------------------------------


def test_ten_adam_steps_match_jax():
    """A tiny FullSubNet (LSTM, dropout 0, MSE, lr 1e-3) from the same
    weights (``random_fullsubnet_params`` through ``state_dict_from_jax``),
    ten Adam steps on one fixed batch of 4 rows of 0.1 s: the port's
    ``train_step`` against JAX's jitted ``make_train_step`` (its scan LSTM,
    the reference's plain path on the CPU; ``tests/torch_fsn_first_step.py``,
    which also runs them at full width).  The first three losses at rtol
    1e-4, as ``tests/test_torch_parallel_2proc.py`` holds its FullSubNet
    steps; all ten at 1e-3."""
    rng = np.random.default_rng(12)
    clean = (rng.standard_normal((4, 1600)) * 0.1).astype(np.float32)
    noisy = (clean + rng.standard_normal(clean.shape) * 0.05).astype(np.float32)
    got, want = adam_losses(noisy, clean, 10, stft=dict(fft_len=64, win_len=48),
                            fb_model_hidden_size=32, sb_model_hidden_size=24, sb_num_neighbors=3,
                            dropout=0.0)
    print(f"FullSubNet losses, port: {got}; JAX: {want}")
    assert np.isfinite(got).all() and len(got) == len(want) == 10
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-3)
