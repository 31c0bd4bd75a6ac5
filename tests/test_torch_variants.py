"""The PyTorch port's model variants (se_tpu_torch) against the JAX package
on the CPU at a tiny width: the complex BatchNorm alone and in DCCRN
(``use_cbn``, train and eval mode), DCCRN and CRN without skip connections,
DCCRN's direct mapping (the ``dccrn_direct`` train step), ``CPReLU``, the
weight grammars of these variants, and the receipt: a port checkpoint of a
no-skip DCCRN with the complex BatchNorm and of a no-skip CRN loads in the
JAX package and enhances to the same waveform.

The JAX weights are numpy trees from ``random_*_params`` handed to flax's
``apply``; the JAX side is jitted, its LSTM kernels run in interpret mode
(``use_pallas_lstm="on"``).  Tolerances: losses rtol 1e-4; outputs atol
1e-4 (f32 through three conv stages, the LSTM and three transposed convs,
as ``tests/test_torch_crn.py``); gradients and running statistics atol
1e-5, rtol 1e-4; the receipt's waveforms atol 1e-5."""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from se_tpu.config import (
    Config as JConfig,
    CrnConfig as JCrnConfig,
    DccrnConfig as JDccrnConfig,
    TrainConfig as JTrainConfig,
)
from se_tpu.models import build_model as jbuild_model
from se_tpu.models.layers import CPReLU as JCPReLU
from se_tpu.ops import norms as jnorms
from se_tpu.train.state import TrainState, make_optimizer as jmake_optimizer
from se_tpu.train.steps import make_train_step
from se_tpu.utils.torch_export import export_reference_state_dict
from se_tpu.utils.torch_import import load_reference_checkpoint as jload_reference_checkpoint

from se_tpu_torch.config import Config, CrnConfig, DccrnConfig, TrainConfig
from se_tpu_torch.enhance import enhance_batch
from se_tpu_torch.models import build_model
from se_tpu_torch.models.layers import ComplexBatchNorm, CPReLU
from se_tpu_torch.ops.norms import ComplexBnState, complex_batch_norm
from se_tpu_torch.train.state import create_train_state
from se_tpu_torch.train.steps import train_step
from se_tpu_torch.utils.weights import (
    random_crn_params,
    random_dccrn_params,
    save_reference_checkpoint,
    state_dict_from_jax,
)

TINY_KN = (8, 16, 16)
TINY_CRN = dict(rnn_input_size=256, rnn_units=32)  # C x D after three stages: 8 x 32
LR = 1e-3
B1 = 0.9  # Adam's first-moment decay in both packages


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


VARIANTS = {
    # name: (model, config overrides of both packages, dccrn.use_cbn)
    "dccrn-cbn": ("DCCRN", dict(), True),
    "dccrn-cbn-noskip": ("DCCRN", dict(skip_type=False), True),
    "dccrn-noskip": ("DCCRN", dict(skip_type=False), False),
    # MSE, as the JAX package's own direct-mapping tests: SDR along time is
    # log10(0) on the spectra's rows that are 0 in every frame (the DC and
    # Nyquist bins' imaginary parts), in both packages and the reference
    "dccrn-direct": ("DCCRN", dict(masking_mode="Direct(None make)", loss="MSE"), False),
    "crn-noskip": ("CRN", dict(skip_type=False), False),
}


def _cfgs(variant, accum=1):
    model, kw, cbn = VARIANTS[variant]
    common = dict(model=model, loss="MSE" if model == "CRN" else "SDR",
                  lstm="real" if model == "CRN" else "complex")
    common.update(kw)
    return (
        JConfig(**common, dccrn=JDccrnConfig(kernel_num=TINY_KN, rnn_units=32, use_cbn=cbn),
                crn=JCrnConfig(**TINY_CRN), use_pallas_lstm="on",
                train=JTrainConfig(learning_rate=LR, grad_accum=accum)),
        Config(**common, dccrn=DccrnConfig(kernel_num=TINY_KN, rnn_units=32, use_cbn=cbn),
               crn=CrnConfig(**TINY_CRN), train=TrainConfig(learning_rate=LR, grad_accum=accum)),
    )


def _tree(variant):
    _, cfg = _cfgs(variant)
    return (random_crn_params if cfg.model == "CRN" else random_dccrn_params)(cfg, seed=0)


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(0)
    clean = (rng.standard_normal((2, 4000)) * 0.1).astype(np.float32)
    noisy = (clean + rng.standard_normal((2, 4000)) * 0.05).astype(np.float32)
    return types.SimpleNamespace(noisy=noisy, clean=clean)


def _port(variant, tree=None):
    _, cfg = _cfgs(variant)
    model, opt = create_train_state(cfg, state_dict_from_jax(*(tree or _tree(variant)), cfg),
                                    device="cpu")
    return model, opt


def _sd(variant, params, bstats):
    """A JAX ``(params, batch_stats)`` tree (any leaves) -> the port's names,
    numpy values."""
    _, cfg = _cfgs(variant)
    to_np = lambda t: jax.tree.map(np.array, t)
    return {k: v.numpy() for k, v in state_dict_from_jax(to_np(params), to_np(bstats),
                                                         cfg).items()}


def _stats(model):
    return {k: v.numpy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var")) or k.rsplit(".", 1)[-1] in
            ComplexBnState._fields}


# --- the complex BatchNorm and CPReLU alone ------------------------------------


def _cbn_case(seed=0, B=3, C=4, H=5, W=7):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (rng.standard_normal((B, 2 * C, H, W)) * 0.7 + 0.3).astype(f)
    x[:, C:] += 0.5 * x[:, :C]  # real and imaginary parts correlated
    params = (1 + 0.1 * rng.standard_normal(C), rng.uniform(-0.9, 0.9, C),
              1 + 0.1 * rng.standard_normal(C), 0.1 * rng.standard_normal(C),
              0.1 * rng.standard_normal(C))
    state = (0.1 * rng.standard_normal(C), 0.1 * rng.standard_normal(C),
             rng.uniform(0.5, 1.5, C), rng.uniform(-0.2, 0.2, C), rng.uniform(0.5, 1.5, C))
    cot = rng.standard_normal(x.shape).astype(f)
    return x, [np.asarray(p, f) for p in params], [np.asarray(s, f) for s in state], cot


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_complex_batch_norm_matches_jax(train):
    """Output and the new running statistics at atol 1e-5, rtol 1e-4; the
    gradients of x and of the five parameters likewise (``jax.vjp``)."""
    x, params, state, cot = _cbn_case()

    def jfn(x, *p):
        return jnorms.complex_batch_norm(x, *p, jnorms.ComplexBnState(*map(jnp.asarray, state)),
                                         train)

    (want, want_state), vjp = jax.vjp(jfn, jnp.asarray(x), *map(jnp.asarray, params))
    want_grads = vjp((jnp.asarray(cot), jax.tree.map(jnp.zeros_like, want_state)))

    args = [_t(a).requires_grad_() for a in (x, *params)]
    got, got_state = complex_batch_norm(args[0], *args[1:], ComplexBnState(*map(_t, state)),
                                        train)
    got_grads = torch.autograd.grad(got, args, _t(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    for name, g, w in zip(ComplexBnState._fields, got_state, want_state):
        assert not g.requires_grad, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4, err_msg=name)
    for name, g, w in zip(("x", "Wrr", "Wri", "Wii", "Br", "Bi"), got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4, err_msg=name)


def test_complex_batch_norm_module_names_init_and_updates():
    """The reference's parameter and buffer names and initial values (the
    identity whitening, no shift, zero means, unit variances), ``Wri`` from
    U(-0.9, 0.9) with the module's generator, the running statistics moved
    in train mode only."""
    m = ComplexBatchNorm(8, generator=torch.Generator().manual_seed(0))
    assert list(m.state_dict()) == ["Wrr", "Wri", "Wii", "Br", "Bi", "RMr", "RMi", "RVrr",
                                    "RVri", "RVii"]
    assert m.Wri.abs().max().item() <= 0.9 and m.Wri.std().item() > 0
    for name, value in (("Wrr", 1.0), ("Wii", 1.0), ("Br", 0.0), ("Bi", 0.0), ("RMr", 0.0),
                        ("RMi", 0.0), ("RVrr", 1.0), ("RVri", 0.0), ("RVii", 1.0)):
        assert torch.equal(getattr(m, name), torch.full((4,), value)), name
    again = ComplexBatchNorm(8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(m.Wri, again.Wri)
    x = _t(_cbn_case(C=4)[0])
    m.eval()(x)
    assert torch.equal(m.RMr, torch.zeros(4)) and torch.equal(m.RVrr, torch.ones(4))
    m.train()(x)
    assert m.RMr.abs().max().item() > 0 and not torch.equal(m.RVri, torch.zeros(4))


def test_cprelu_matches_jax():
    """Forward and input gradient exactly, slope gradients at rtol 1e-6: a
    slope for the real half and one for the imaginary half, 0.25 each at
    init; positive values pass unchanged."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 4)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jm = JCPReLU()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    slopes = {"r_weight": np.array([0.25], np.float32), "i_weight": np.array([-0.4], np.float32)}
    variables = {"params": {k: jnp.asarray(v) for k, v in slopes.items()}}
    want, vjp = jax.vjp(lambda v, x: jm.apply(v, x), variables, jnp.asarray(x))
    dv, dx = vjp(jnp.asarray(cot))

    m = CPReLU()
    assert list(m.state_dict()) == ["r_weight", "i_weight"]
    assert torch.equal(m.r_weight, torch.full((1,), 0.25))
    m.load_state_dict({k: _t(v) for k, v in slopes.items()})
    xt = _t(x).requires_grad_()
    got = m(xt)
    grads = torch.autograd.grad(got, [xt, m.r_weight, m.i_weight], _t(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert torch.equal(got[xt > 0], xt[xt > 0])
    np.testing.assert_array_equal(grads[0].numpy(), np.asarray(dx))
    for g, k in zip(grads[1:], ("r_weight", "i_weight")):
        np.testing.assert_allclose(g.numpy(), np.asarray(dv["params"][k]), rtol=1e-6)


# --- weights -------------------------------------------------------------------


def _key_shapes(tree) -> dict:
    """``{path: shape}`` of a tree's leaves, the path by dict key or field
    name, so that two packages' ``ComplexBnState`` classes compare equal."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    name = lambda k: getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))
    return {tuple(str(name(k)) for k in path): np.shape(v) for path, v in flat}


@pytest.mark.parametrize("variant", ["dccrn-cbn-noskip", "dccrn-noskip", "crn-noskip"])
def test_random_tree_has_flax_layout(variant):
    jcfg, _ = _cfgs(variant)
    shapes = jax.eval_shape(lambda: jbuild_model(jcfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4000)), train=False))
    params, bstats = _tree(variant)
    assert _key_shapes({"params": params, "batch_stats": bstats}) == _key_shapes(dict(shapes))


@pytest.mark.parametrize("variant", ["dccrn-cbn-noskip", "crn-noskip"])
def test_state_dict_equals_jax_export(variant):
    """Key for key and value for value against the JAX exporter (the
    complex BatchNorm's ten leaves; CRN's bare no-skip decoder convs), then a
    strict load."""
    jcfg, cfg = _cfgs(variant)
    params, bstats = _tree(variant)
    want = export_reference_state_dict(params, bstats, jcfg)
    got = state_dict_from_jax(params, bstats, cfg)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    if cfg.model == "CRN":
        assert "decoder.0.0.weight" in got and "decoder.0.0.conv.weight" not in got
    else:
        assert {"encoder.0.1.Wri", "encoder.0.1.RVri", "decoder.0.1.RVii"} <= got.keys()
    build_model(cfg, device="cpu").load_state_dict(got, strict=True)


# --- the tiny models against JAX ------------------------------------------------


@pytest.mark.parametrize("variant,train", [
    ("dccrn-cbn", False), ("dccrn-cbn", True), ("dccrn-cbn-noskip", True),
    ("dccrn-noskip", False), ("crn-noskip", False), ("crn-noskip", True),
])
def test_forward_matches_jax(tiny, variant, train):
    """Every output at atol 1e-4; in train mode also the running statistics
    the forward leaves, at atol 1e-5, rtol 1e-4 (the complex BatchNorm's
    five, or BatchNorm's two)."""
    jcfg, cfg = _cfgs(variant)
    params, bstats = _tree(variant)
    args = (tiny.noisy, tiny.clean) if cfg.model == "CRN" else (tiny.noisy,)

    def jfwd(*a):
        v = {"params": params, "batch_stats": bstats}
        if train:
            return jbuild_model(jcfg).apply(v, *a, train=True, mutable=["batch_stats"])
        return jbuild_model(jcfg).apply(v, *a, train=False), {"batch_stats": bstats}

    want, mut = jax.jit(jfwd)(*map(jnp.asarray, args))
    m, _ = _port(variant)
    m.train(train)
    with torch.no_grad():
        got = m(*map(_t, args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    want_stats = _sd(variant, params, mut["batch_stats"])
    got_stats = _stats(m)
    assert got_stats
    for k, v in got_stats.items():
        np.testing.assert_allclose(v, want_stats[k], atol=1e-5, rtol=1e-4, err_msg=k)


def _jax_step(variant, accum, noisy, clean):
    """JAX's jitted ``make_train_step`` from ``_tree(variant)`` -> (metrics,
    the averaged gradients and the new running statistics under the port's
    names).  The gradients are read back from Adam's first moment after its
    first step, ``(1 - b1) g``."""
    jcfg, _ = _cfgs(variant, accum)
    params, bstats = _tree(variant)
    tx = jmake_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=0, params=jp, batch_stats=jax.tree.map(jnp.asarray, bstats),
                       opt_state=tx.init(jp), tx=tx)
    state, metrics = make_train_step(jcfg, jbuild_model(jcfg))(
        state, jnp.asarray(noisy), jnp.asarray(clean), jax.random.PRNGKey(0))
    mu = state.opt_state[0].mu
    grads = jax.tree.map(lambda m: np.asarray(m, np.float64) / (1 - B1), mu)
    return metrics, _sd(variant, grads, bstats), _sd(variant, params, state.batch_stats)


def _cancelled_by_batch_norm(model):
    """The biases of a stage's conv (``{section}.{i}.0``, wrapped or bare)
    that feeds a train-mode BatchNorm (real: ``.1.running_mean``; complex:
    ``.1.RMr``): its batch mean removes them, so their exact gradient is 0
    and both packages give roundoff."""
    sd = model.state_dict()
    stage = lambda k: ".".join(k.split(".")[:2])
    return {k for k in sd if k.endswith("bias") and k.split(".")[2:3] == ["0"] and any(
        f"{stage(k)}.1.{s}" in sd for s in ("running_mean", "RMr"))}


@pytest.mark.parametrize("variant,accum", [
    ("dccrn-direct", 1), ("dccrn-direct", 2), ("dccrn-cbn-noskip", 1), ("crn-noskip", 1),
])
def test_train_step_matches_jax(tiny, variant, accum):
    """One ``train_step`` against JAX's ``make_train_step``: the loss at rtol
    1e-4 (``dccrn_direct``: the mean of the real and imaginary spectra's
    losses), every gradient leaf and the running statistics at atol 1e-5,
    rtol 1e-4.  The conv biases that feed a BatchNorm have roundoff
    gradients (exactly 0 in exact arithmetic): both sides below 1e-5 of the
    largest gradient."""
    metrics, want, want_stats = _jax_step(variant, accum, tiny.noisy, tiny.clean)
    _, cfg = _cfgs(variant, accum)
    m, opt = _port(variant)
    got_m = train_step(cfg, m, opt, tiny.noisy, tiny.clean)
    np.testing.assert_allclose(got_m["loss"].item(), float(metrics["loss"]), rtol=1e-4)
    got = {k: p.grad.numpy() for k, p in m.named_parameters()}
    assert got.keys() <= want.keys()
    cancelled = _cancelled_by_batch_norm(m)
    assert len(cancelled) == (5 if cfg.model == "CRN" else 10)
    scale = max(np.abs(w).max() for w in want.values())
    for k, g in got.items():
        if k in cancelled:
            assert max(np.abs(g).max(), np.abs(want[k]).max()) <= 1e-5 * scale, k
        else:
            np.testing.assert_allclose(g, want[k], atol=1e-5, rtol=1e-4, err_msg=k)
    for k, v in _stats(m).items():
        np.testing.assert_allclose(v, want_stats[k], atol=1e-5, rtol=1e-4, err_msg=k)


def test_direct_dccrn_returns_target_spectra_and_needs_targets(tiny):
    """Direct mapping returns (out_real, target_real, out_imag, target_imag,
    wav), the targets' spectrum being the model's own STFT of the targets;
    without targets it raises, so the enhance path cannot run it."""
    m, _ = _port("dccrn-direct")
    with torch.no_grad():
        out_r, tgt_r, out_i, tgt_i, wav = m(_t(tiny.noisy), _t(tiny.clean))
        specs = m.stft(_t(tiny.clean))
    dim = specs.shape[1] // 2
    assert torch.equal(tgt_r, specs[:, :dim]) and torch.equal(tgt_i, specs[:, dim:])
    assert out_r.shape == tgt_r.shape == out_i.shape == tgt_i.shape
    assert wav.shape == (2, 4000) and wav.abs().max().item() <= 1.0
    with pytest.raises(ValueError, match="needs targets"):
        enhance_batch(m, tiny.noisy, device="cpu")


# --- the receipt: a port checkpoint read by the JAX package -------------------


@pytest.mark.parametrize("variant", ["dccrn-cbn-noskip", "crn-noskip"])
def test_port_checkpoint_enhances_the_same_in_jax(tiny, variant, tmp_path):
    """One port train step (so every leaf, running statistics included, is
    the port's), its state dict saved as the reference's blob, loaded by
    ``se_tpu.utils.torch_import.load_reference_checkpoint`` (which checks the
    tree against the JAX model's own) and applied in eval mode: the enhanced
    waveform within 1e-5 of the port's."""
    jcfg, cfg = _cfgs(variant)
    m, opt = _port(variant)
    train_step(cfg, m, opt, tiny.noisy, tiny.clean)
    path = save_reference_checkpoint(str(tmp_path / "chkpt_1.pt"), m.state_dict(), epoch=1)
    variables, epoch = jload_reference_checkpoint(path, jcfg)
    assert epoch == 1
    args = (tiny.noisy, tiny.clean) if cfg.model == "CRN" else (tiny.noisy,)
    want = jax.jit(lambda *a: jbuild_model(jcfg).apply(variables, *a, train=False)[-1])(
        *map(jnp.asarray, args))
    got = enhance_batch(m, tiny.noisy, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
