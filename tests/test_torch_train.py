"""The PyTorch port's train step (se_tpu_torch) against the JAX package on
the CPU at a tiny width: the fused LSTM scan's backward, the zero-safe
magnitude and phase gradients, the DCCRN's gradients and BatchNorm running
statistics in train mode, Adam, and whole train steps with and without
gradient accumulation.

The JAX side runs its Pallas LSTM kernel (``use_pallas_lstm="on"``) in
interpret mode, as the JAX package's own tests do on the CPU.  Inputs come
from numpy seeds and go through both packages."""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from se_tpu.config import (
    Config as JConfig,
    DccrnConfig as JDccrnConfig,
    TrainConfig as JTrainConfig,
)
from se_tpu.models import build_model as jbuild_model
from se_tpu.ops import magnitude as jmag
from se_tpu.ops import pallas_lstm
from se_tpu.train.state import TrainState, make_optimizer as jmake_optimizer
from se_tpu.train.steps import _loss_and_outputs, make_train_step

from se_tpu_torch.config import Config, DccrnConfig, TrainConfig
from se_tpu_torch.losses import main_loss
from se_tpu_torch.ops import fused_lstm
from se_tpu_torch.ops.fused_lstm import (
    fused_lstm_scan,
    fused_lstm_scan_backward,
    fused_lstm_scan_backward_reference,
    fused_lstm_scan_reference,
)
from se_tpu_torch.ops.magnitude import complex_mag, safe_arctan2
from se_tpu_torch.train.state import AdamLowPrecisionMu, create_train_state, make_optimizer
from se_tpu_torch.train.steps import train_step
from se_tpu_torch.utils.weights import dccrn_state_dict_from_jax, random_dccrn_params

TINY = dict(kernel_num=(8, 16, 16), rnn_units=32)
LR = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run gives each of its workers a share of the cores; torch's
    default pool of one thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_case(T=12, L=2, Bb=6, H=16, seed=0):
    """Forward inputs (nonzero h0, c0) and seeded cotangents of (ys, hT, cT)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (
        rng.standard_normal((T, L, Bb, 4 * H)).astype(f),
        rng.uniform(-0.25, 0.25, (L, H, 4 * H)).astype(f),
        (rng.standard_normal((L, Bb, H)) * 0.5).astype(f),
        (rng.standard_normal((L, Bb, H)) * 0.5).astype(f),
    ), (
        rng.standard_normal((T, L, Bb, H)).astype(f),
        rng.standard_normal((L, Bb, H)).astype(f),
        rng.standard_normal((L, Bb, H)).astype(f),
    )


def _torch_grads(fn, inputs, cots):
    """Gradients of the four inputs of ``fn`` for the cotangents ``cots``."""
    args = [_t(a).requires_grad_() for a in inputs]
    ys, (hT, cT) = fn(*args)
    dys, dhT, dcT = map(_t, cots)
    total = (ys * dys).sum() + (hT * dhT).sum() + (cT * dcT).sum()
    return torch.autograd.grad(total, args)


def test_fused_lstm_scan_backward_matches_pallas_vjp():
    """The port's Function (plain forward with the stash, plain backward) on
    the CPU against ``jax.vjp`` of the Pallas kernel run in interpret mode.
    atol 1e-5, rtol 1e-4: the same f32 arithmetic summed in another order
    over 12 steps; dW_hh sums 72 rows."""
    inputs, cots = _scan_case()
    (_, vjp) = jax.vjp(pallas_lstm.fused_lstm_scan, *map(jnp.asarray, inputs))
    dys, dhT, dcT = map(jnp.asarray, cots)
    want = vjp((dys, (dhT, dcT)))
    got = _torch_grads(fused_lstm_scan, inputs, cots)
    for name, g, w in zip(("dx_proj", "dw_hh_t", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("cotangents", ["all", "ys-only"])
@pytest.mark.parametrize("shape", [(12, 2, 6, 16), (7, 3, 5, 8)], ids=["even", "ragged"])
def test_plain_backward_matches_autograd_of_plain_forward(shape, cotangents):
    """``fused_lstm_scan_backward_reference`` against torch's autograd of
    the plain recurrence; with zero cotangents for (hT, cT), as autograd
    hands them over when the final state is unused.  atol 1e-5."""
    inputs, cots = _scan_case(*shape, seed=1)
    if cotangents == "ys-only":
        cots = (cots[0], np.zeros_like(cots[1]), np.zeros_like(cots[2]))
    want = _torch_grads(fused_lstm_scan_reference, inputs, cots)
    ys, cs, _, _ = fused_lstm._reference_forward(*map(_t, inputs), need_cs=True)
    got = fused_lstm_scan_backward_reference(*map(_t, inputs), ys, cs, *map(_t, cots))
    for name, g, w in zip(("dx_proj", "dw_hh_t", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, err_msg=name)


def test_backward_wrapper_on_cpu_runs_plain_without_counting():
    inputs, cots = _scan_case(T=5, L=2, Bb=3, H=8)
    ys, cs, _, _ = fused_lstm._reference_forward(*map(_t, inputs), need_cs=True)
    args = (*map(_t, inputs), ys, cs, *map(_t, cots))
    before = fused_lstm_scan_backward.launches, fused_lstm_scan.launches
    got = fused_lstm_scan_backward(*args)
    want = fused_lstm_scan_backward_reference(*args)
    assert (fused_lstm_scan_backward.launches, fused_lstm_scan.launches) == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        fused_lstm_scan_backward(*args[:4], ys[:-1], *args[5:])


def test_stash_only_when_a_gradient_is_needed(monkeypatch):
    """Under ``no_grad`` and ``inference_mode``, and with no input needing a
    gradient, the forward writes no stash (the inference path keeps its
    memory); with one, the Function saves ``cs [T, L, Bb, H]``."""
    inputs, _ = _scan_case(T=6, L=2, Bb=3, H=8)
    asked = []
    real = fused_lstm._reference_forward

    def spy(x_proj, w_hh_t, h0, c0, need_cs):
        asked.append(need_cs)
        return real(x_proj, w_hh_t, h0, c0, need_cs)

    monkeypatch.setattr(fused_lstm, "_reference_forward", spy)
    args = [_t(a).requires_grad_() for a in inputs]
    with torch.no_grad():
        fused_lstm_scan(*args)
    with torch.inference_mode():
        fused_lstm_scan(*map(_t, inputs))
    fused_lstm_scan(*map(_t, inputs))
    assert asked == [False, False, False]
    ys, _ = fused_lstm_scan(*args)
    assert asked[-1] is True
    saved = ys.grad_fn.saved_tensors
    assert len(saved) == 6 and tuple(saved[-1].shape) == (6, 2, 3, 8)


def test_magnitude_and_phase_gradients_match_jax_and_vanish_at_origin():
    """``complex_mag`` and ``safe_arctan2``: forwards bit-identical to the
    naive expressions; gradients equal to ``jax.vjp`` of the JAX package's
    functions at rtol 1e-6, and exactly 0 where both parts are 0."""
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((2, 4, 9)).astype(np.float32)
    a[:, :3] = 0.0
    b[:, :3] = 0.0
    b[:, 3] = 0.0  # on an axis, away from the origin
    g = rng.standard_normal((4, 9)).astype(np.float32)
    for tfn, jfn, naive in (
        (complex_mag, jmag.complex_mag, lambda x, y: (x**2 + y**2) ** 0.5),
        (safe_arctan2, jmag.safe_arctan2, torch.atan2),
    ):
        x, y = _t(a).requires_grad_(), _t(b).requires_grad_()
        out = tfn(x, y)
        assert torch.equal(out, naive(_t(a), _t(b)))
        got = torch.autograd.grad(out, (x, y), _t(g))
        _, vjp = jax.vjp(jfn, jnp.asarray(a), jnp.asarray(b))
        for gt, gj in zip(got, vjp(jnp.asarray(g))):
            assert np.all(gt.numpy()[:, :3] == 0.0)
            assert np.isfinite(gt.numpy()).all()
            np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6, atol=1e-7)


def test_make_optimizer_matches_optax_adam():
    """The port's Adam against the JAX package's ``make_optimizer`` (optax
    ``adam``) on one synthetic gradient sequence spanning 1e-6 to 30, which
    pins bias correction and eps placement: 20 steps, atol 1e-6."""
    rng = np.random.default_rng(3)
    shapes, scales = [(7, 5), (64,), (3, 3, 2, 4)], [1e-6, 1.0, 30.0]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(sc * rng.standard_normal(s)).astype(np.float32) for s, sc in zip(shapes, scales)]
             for _ in range(20)]
    jcfg, cfg = JConfig(train=JTrainConfig(learning_rate=LR)), Config(train=TrainConfig(learning_rate=LR))

    module = torch.nn.ParameterList([torch.nn.Parameter(_t(p)) for p in p0])
    opt = make_optimizer(cfg, module)
    for gs in grads:
        for p, gi in zip(module, gs):
            p.grad = _t(gi)
        opt.step()

    tx = jmake_optimizer(jcfg)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    for gs in grads:
        updates, state = tx.update([jnp.asarray(gi) for gi in gs], state, jp)
        jp = optax.apply_updates(jp, updates)
    for p, q in zip(module, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), atol=1e-6)

    # a bf16 first moment takes the port's own Adam (tests/test_torch_bf16.py)
    assert type(opt) is torch.optim.Adam
    bf16_mu = make_optimizer(Config(train=TrainConfig(adam_mu_dtype="bfloat16")), module)
    assert isinstance(bf16_mu, AdamLowPrecisionMu)


# --- the tiny DCCRN in train mode ------------------------------------------


def _cfgs(accum=1):
    return (
        JConfig(dccrn=JDccrnConfig(**TINY), use_pallas_lstm="on",
                train=JTrainConfig(learning_rate=LR, grad_accum=accum)),
        Config(dccrn=DccrnConfig(**TINY), train=TrainConfig(learning_rate=LR, grad_accum=accum)),
    )


@pytest.fixture(scope="module")
def tiny():
    _, cfg = _cfgs()
    params, bstats = random_dccrn_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    clean = (rng.standard_normal((2, 4000)) * 0.1).astype(np.float32)
    noisy = (clean + rng.standard_normal((2, 4000)) * 0.05).astype(np.float32)
    return types.SimpleNamespace(params=params, bstats=bstats, noisy=noisy, clean=clean)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _params_sd(params, bstats, cfg):
    return {k: v.numpy() for k, v in dccrn_state_dict_from_jax(params, bstats, cfg).items()}


def _port_model(tiny, cfg):
    model, opt = create_train_state(
        cfg, dccrn_state_dict_from_jax(tiny.params, tiny.bstats, cfg), device="cpu"
    )
    return model, opt


def _cancelled_by_batch_norm(model):
    """The conv biases that feed a train-mode BatchNorm.  Its batch mean
    removes them, so their exact gradient is 0 and both packages give
    roundoff there."""
    sd = model.state_dict()
    return {k for k in sd if k.endswith("_conv.bias")
            and k.rsplit(".", 3)[0] + ".1.running_mean" in sd}


def _running_stats(model):
    return {k: v.numpy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def test_dccrn_train_gradients_and_running_stats_match_jax(tiny):
    """SDR loss at rtol 1e-4; each parameter's gradient within
    1e-3 x max |JAX leaf| (f32 through convs, two 43-step LSTM layers, the
    E-mask's atan2 and the iSTFT, forward and back), except the conv biases
    that feed a BatchNorm: their exact gradient is 0, so both sides must be
    below 1e-5 x the largest gradient; the running statistics after the
    train-mode forward at atol 1e-5."""
    jcfg, cfg = _cfgs()
    jmodel = jbuild_model(jcfg)

    def loss_fn(params):
        loss, (_, _, new_bs) = _loss_and_outputs(
            jcfg, jmodel, params, _jtree(tiny.bstats), jnp.asarray(tiny.noisy),
            jnp.asarray(tiny.clean), train=True, dropout_rng=None,
        )
        return loss, new_bs

    (want_loss, new_bs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _jtree(tiny.params)
    )
    want = _params_sd(_np_tree(grads), _np_tree(new_bs), cfg)

    model, _ = _port_model(tiny, cfg)
    model.train()
    _, _, out = model(_t(tiny.noisy))
    loss = main_loss(cfg.loss, out, _t(tiny.clean))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    cancelled = _cancelled_by_batch_norm(model)
    assert got.keys() <= want.keys() and len(cancelled) == 10
    scale = max(np.abs(want[k]).max() for k in got)
    for k, g in got.items():
        w = want[k]
        if k in cancelled:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-5 * scale, k
        else:
            err = np.abs(g - w).max()
            assert err <= 1e-3 * np.abs(w).max(), (k, err, np.abs(w).max())
    for k, v in _running_stats(model).items():
        np.testing.assert_allclose(v, want[k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(tiny, accum):
    """One ``train_step`` against the JAX package's jitted
    ``make_train_step`` (Adam, lr 1e-3): loss at rtol 1e-4, running
    statistics at atol 1e-5.  Adam's first step moves each parameter by
    about lr * sign(g) wherever |g| is far above eps, so where a gradient
    is at roundoff level its sign, and the update, can flip: every
    parameter within 2 lr, and at most 0.1% of entries off by more than
    1e-5 once the conv biases that feed a BatchNorm, whose gradient is all
    roundoff, are left out."""
    jcfg, cfg = _cfgs(accum)
    jmodel = jbuild_model(jcfg)
    tx = jmake_optimizer(jcfg)
    params = _jtree(tiny.params)
    state = TrainState(step=0, params=params, batch_stats=_jtree(tiny.bstats),
                       opt_state=tx.init(params), tx=tx)
    state, metrics = make_train_step(jcfg, jmodel)(
        state, jnp.asarray(tiny.noisy), jnp.asarray(tiny.clean), jax.random.PRNGKey(0)
    )
    want = _params_sd(_np_tree(state.params), _np_tree(state.batch_stats), cfg)

    model, opt = _port_model(tiny, cfg)
    got_m = train_step(cfg, model, opt, tiny.noisy, tiny.clean)
    assert model.training and got_m["loss"].ndim == 0
    np.testing.assert_allclose(got_m["loss"].item(), float(metrics["loss"]), rtol=1e-4)
    for k, v in _running_stats(model).items():
        np.testing.assert_allclose(v, want[k], atol=1e-5, err_msg=k)
    cancelled = _cancelled_by_batch_norm(model)
    deltas = {k: np.abs(p.detach().numpy() - want[k]).ravel()
              for k, p in model.named_parameters()}
    assert max(d.max() for d in deltas.values()) <= 2 * LR
    rest = np.concatenate([d for k, d in deltas.items() if k not in cancelled])
    assert np.mean(rest > 1e-5) <= 1e-3, np.mean(rest > 1e-5)


def test_grad_accum_leaves_the_mean_of_micro_batch_gradients(tiny):
    """With ``grad_accum=2`` each parameter's ``.grad`` is the mean of the
    two rows' own gradients (atol 1e-6 relative to the leaf), the LSTM's
    ``bias_ih`` and ``bias_hh`` included: autograd hands those two views of
    one tensor, which an in-place accumulation would count twice."""
    _, cfg = _cfgs(2)
    want = []
    for i in range(2):
        model, _ = _port_model(tiny, cfg)
        model.train()
        _, _, out = model(_t(tiny.noisy[i : i + 1]))
        params = list(model.parameters())
        want.append(torch.autograd.grad(main_loss(cfg.loss, out, _t(tiny.clean[i : i + 1])),
                                        params))
    model, opt = _port_model(tiny, cfg)
    train_step(cfg, model, opt, tiny.noisy, tiny.clean)
    for p, a, b in zip(model.parameters(), *want):
        mean = (a + b) / 2
        assert torch.allclose(p.grad, mean, rtol=0, atol=1e-6 * mean.abs().max().item() + 1e-12)
    lstm = model.enhance[0].real_lstm
    assert lstm.bias_ih_l0.grad.data_ptr() != lstm.bias_hh_l0.grad.data_ptr()


def test_train_step_rejects_unported_variants_and_ragged_accumulation(tiny):
    """Every trainer variant is ported: the perceptual one runs and reports
    its two terms (held to the JAX package in
    ``tests/test_torch_perceptual.py``); a batch that does not split into
    the micro-batches raises."""
    _, cfg = _cfgs()
    model, opt = _port_model(tiny, cfg)
    metrics = train_step(cfg.replace(perceptual="LMS"), model, opt, tiny.noisy, tiny.clean)
    assert set(metrics) == {"loss", "main_loss", "perceptual_loss"}
    with pytest.raises(ValueError, match="micro-batches"):
        train_step(cfg.replace(train=TrainConfig(grad_accum=3)), model, opt,
                   tiny.noisy, tiny.clean)
