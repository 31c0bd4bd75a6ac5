"""DCCRN's ``remat_convs`` in the PyTorch port on the CPU at a tiny width:
each encoder and decoder stage recomputed in the backward
(``torch.utils.checkpoint``) leaves the train step's loss, gradients and
running statistics as they are without it, the recompute updating no
BatchNorm a second time; and the port's remat step against the JAX
package's ``remat_convs=True`` step (``nn.remat``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from se_tpu.config import Config as JConfig, DccrnConfig as JDccrnConfig
from se_tpu.models import build_model as jbuild_model
from se_tpu.train.steps import _loss_and_outputs

from se_tpu_torch.config import Config, DccrnConfig
from se_tpu_torch.ops import fused_conv
from se_tpu_torch.train.state import create_train_state
from se_tpu_torch.train.steps import train_step
from se_tpu_torch.utils.weights import random_dccrn_params, state_dict_from_jax

TINY = dict(kernel_num=(8, 16, 16), rnn_units=32)
GRAD_TOL = 1e-6  # remat against none, of each leaf's max


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run gives each of its workers a share of the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(n=4000):
    rng = np.random.default_rng(0)
    clean = (rng.standard_normal((2, n)) * 0.1).astype(np.float32)
    noisy = (clean + rng.standard_normal((2, n)) * 0.05).astype(np.float32)
    return noisy, clean


def _step(cfg, sd, noisy, clean):
    """One ``train_step`` from ``sd`` -> (loss, gradients, state dict after
    the step)."""
    model, opt = create_train_state(cfg, sd, device="cpu")
    loss = train_step(cfg, model, opt, noisy, clean)["loss"].item()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return loss, grads, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("variant", ["default", "use_cbn", "use_pallas_conv"])
def test_remat_step_equals_the_plain_step(variant, monkeypatch):
    """With ``remat_convs`` the step's loss has the same bits, every
    gradient lies within 1e-6 of its leaf's max, the running statistics and
    every parameter after Adam's step are bit-equal, and each BatchNorm's
    ``num_batches_tracked`` went up by one (the recompute updated none).
    The fused conv (K4's plain version here) runs once more a stage in the
    recompute: a call a stage becomes two (at full width 6 a step become
    12)."""
    extra = {"default": {}, "use_cbn": {"dccrn": DccrnConfig(**TINY, use_cbn=True)},
             "use_pallas_conv": {"use_pallas_conv": True}}[variant]
    cfg = Config(**{"dccrn": DccrnConfig(**TINY), **extra})
    sd = state_dict_from_jax(*random_dccrn_params(cfg, seed=0), cfg)
    noisy, clean = _batch()
    calls = []
    real = fused_conv.reference
    monkeypatch.setattr(fused_conv, "reference", lambda *a, **k: calls.append(1) or real(*a, **k))
    loss, grads, after = _step(cfg, sd, noisy, clean)
    plain_calls = len(calls)
    loss_r, grads_r, after_r = _step(cfg.replace(remat_convs=True), sd, noisy, clean)
    assert loss_r == loss
    for k, g in grads.items():
        err = (grads_r[k] - g).abs().max().item()
        assert err <= GRAD_TOL * g.abs().max().item(), (k, err)
    assert after_r.keys() == after.keys()
    for k, v in after.items():
        assert torch.equal(after_r[k], v), k
    if variant != "use_cbn":  # the complex BatchNorm keeps no count
        tracked = [v.item() for k, v in after_r.items() if k.endswith("num_batches_tracked")]
        assert tracked and set(tracked) == {1}, tracked
    stats = [k for k in after if k.endswith(("running_mean", "RMr"))]
    assert stats and all(not torch.equal(after[k], sd[k]) for k in stats)
    n_stages = len(TINY["kernel_num"])
    if variant == "use_pallas_conv":
        assert (plain_calls, len(calls) - plain_calls) == (n_stages, 2 * n_stages)
    else:
        assert not calls


def test_remat_step_matches_jax_remat():
    """The port's remat step against the JAX package's ``remat_convs=True``
    forward and gradient (``nn.remat``; its Pallas LSTM in interpret mode),
    at ``tests/test_torch_train.py``'s DCCRN tolerances: the SDR loss at
    rtol 1e-4, each gradient within 1e-3 of its JAX leaf's max (the conv
    biases that feed a BatchNorm, whose exact gradient is 0, below 1e-5 of
    the largest gradient on both sides), the running statistics at atol
    1e-5."""
    jcfg = JConfig(dccrn=JDccrnConfig(**TINY), use_pallas_lstm="on", remat_convs=True)
    cfg = Config(dccrn=DccrnConfig(**TINY), remat_convs=True)
    params, bstats = random_dccrn_params(cfg, seed=0)
    noisy, clean = _batch()
    jmodel = jbuild_model(jcfg)

    def loss_fn(p):
        loss, (_, _, new_bs) = _loss_and_outputs(
            jcfg, jmodel, p, jax.tree.map(jnp.asarray, bstats), jnp.asarray(noisy),
            jnp.asarray(clean), train=True, dropout_rng=None)
        return loss, new_bs

    (want_loss, new_bs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.array, grads), jax.tree.map(np.array, new_bs), cfg).items()}

    model, opt = create_train_state(cfg, state_dict_from_jax(params, bstats, cfg), device="cpu")
    loss = train_step(cfg, model, opt, noisy, clean)["loss"].item()
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-4)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    sd = model.state_dict()
    cancelled = {k for k in sd if k.endswith("_conv.bias")
                 and k.rsplit(".", 3)[0] + ".1.running_mean" in sd}
    assert len(cancelled) == 10
    scale = max(np.abs(want[k]).max() for k in got)
    for k, g in got.items():
        if k in cancelled:
            assert max(np.abs(g).max(), np.abs(want[k]).max()) <= 1e-5 * scale, k
        else:
            assert np.abs(g - want[k]).max() <= 1e-3 * np.abs(want[k]).max(), k
    for k, v in sd.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k], atol=1e-5, err_msg=k)
