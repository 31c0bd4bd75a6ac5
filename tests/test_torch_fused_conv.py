"""The port's fused encoder conv (K4, ``se_tpu_torch/ops/fused_conv.py``)
and the DCCRN with ``use_pallas_conv=True`` against the JAX package on the
CPU.  The JAX side runs its Pallas conv in interpret mode, as
``tests/test_pallas_conv.py`` does; the port's wrapper takes its plain
version for CPU tensors.  Inputs from numpy seeds, tiny widths."""

import functools
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import se_tpu.ops.pallas_conv as PC
from se_tpu.config import Config as JConfig, DccrnConfig as JDccrnConfig
from se_tpu.config import TrainConfig as JTrainConfig
from se_tpu.models import build_model as jbuild_model
from se_tpu.train.state import TrainState, make_optimizer as jmake_optimizer
from se_tpu.train.steps import _loss_and_outputs, eval_step_body, make_train_step

from se_tpu_torch.config import Config, DccrnConfig, TrainConfig
from se_tpu_torch.losses import main_loss
from se_tpu_torch.models import build_model
from se_tpu_torch.ops import fused_conv
from se_tpu_torch.ops.fused_conv import fused_complex_conv2d
from se_tpu_torch.train.state import create_train_state
from se_tpu_torch.train.steps import eval_step, train_step
from se_tpu_torch.utils.weights import dccrn_state_dict_from_jax, random_dccrn_params

TINY = dict(kernel_num=(8, 16, 16), rnn_units=32)
LR = 1e-3


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """The JAX package's fused_complex_conv2d looks _pallas_conv up by name."""
    monkeypatch.setattr(
        PC, "_pallas_conv", functools.partial(PC._pallas_conv, interpret=True)
    )


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run gives each of its workers a share of the cores; torch's
    default pool of one thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(rng, B2, C, F, T, Co):
    return (rng.standard_normal((B2, C, F, T)).astype(np.float32),
            (rng.standard_normal((Co, C, 5, 2)) * 0.05).astype(np.float32),
            rng.standard_normal(Co).astype(np.float32))


@pytest.mark.parametrize(
    "shape",
    [
        (4, 2, 256, 100, 16),  # DCCRN stage 1
        (4, 16, 128, 130, 32),  # stage 2
        (2, 64, 32, 77, 128),  # stage 4
        (2, 128, 8, 33, 128),  # stage 6-ish
    ],
)
def test_plain_version_matches_pallas_conv(shape):
    """atol 2e-5, the tolerance of tests/test_pallas_conv.py."""
    x, w, b = _case(np.random.default_rng(0), *shape)
    want = np.asarray(PC._pallas_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = fused_conv.reference(*map(torch.from_numpy, (x, w, b)))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_gradients_match_jax_grad_through_fused_conv():
    """Gradients of sum(y^2) for x, w and b at atol 1e-3 (as
    tests/test_pallas_conv.py, whose weights are N(0, 1); here they are
    0.05 N(0, 1) as in its forward cases, which keeps the gradients near 10
    rather than 1e3, where f32 sums in two libraries' orders differ by
    1e-3); the wrapper on CPU tensors launches nothing."""
    x, w, b = _case(np.random.default_rng(1), 2, 4, 16, 37, 8)
    want = jax.grad(lambda *a: jnp.sum(PC.fused_complex_conv2d(*a) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, w, b)))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    before = fused_complex_conv2d.launches
    got = torch.autograd.grad((fused_complex_conv2d(*args) ** 2).sum(), args)
    assert fused_complex_conv2d.launches == before
    for g, e in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-3)


def test_odd_f_and_other_geometries_raise():
    rng = np.random.default_rng(2)
    x, w, b = map(torch.from_numpy, _case(rng, 2, 3, 15, 37, 4))
    with pytest.raises(ValueError, match="F must be even"):
        fused_complex_conv2d(x, w, b)
    x, w, b = map(torch.from_numpy, _case(rng, 2, 3, 16, 37, 4))
    with pytest.raises(ValueError, match=r"5, 2"):
        fused_complex_conv2d(x, w[..., :3, :].contiguous(), b)
    with pytest.raises(ValueError, match="do not fit"):
        fused_complex_conv2d(x, w[:, :2].contiguous(), b)


def _chunked_conv(x, wp, b):
    """The bf16 kernel's GEMM written out in f32 torch: the im2col rows in
    its order, chunks of 8 channels, each chunk tap by tap (row 80 (c // 8)
    + 8 (2 kf + kt) + c % 8, zero past C), against the rows of
    ``tensor_core_weights``, + b."""
    B2, C, Fq, T = x.shape
    Co, Kp = wp.shape
    chunks = Kp // 80
    xp = torch.nn.functional.pad(x, (1, 0, 2, 2, 0, 8 * chunks - C))  # frame -1, padding 2, channels
    taps = [xp[:, :, kf : kf + Fq : 2, kt : kt + T] for kf in range(5) for kt in range(2)]
    a = torch.stack(taps, 1).reshape(B2, 10, chunks, 8, Fq // 2 * T).transpose(1, 2)
    y = torch.einsum("bkm,ok->bom", a.reshape(B2, Kp, -1), wp.float()) + b[None, :, None]
    return y.reshape(B2, Co, Fq // 2, T)


@pytest.mark.parametrize("C", [1, 3, 8, 20])
def test_kernel_weight_layouts_give_the_conv(C):
    """The kernels' weight layouts: the f32 kernel's ``wt [10 C, Cop]``, w's
    rows as columns, zero to Cop = Co rounded up to 4 (16-byte rows); the
    bf16 kernel's ``[Co, 10 Cp]`` bf16, Cp = C rounded up to 8, in chunks of
    8 channels tap by tap (160-byte rows a chunk), zeros past C; the latter
    multiplied with the im2col rows in the same order gives the conv (atol
    1e-5 on bf16-exact weights)."""
    rng = np.random.default_rng(5)
    Co = 5
    x, w, b = map(torch.from_numpy, _case(rng, 2, C, 12, 9, Co))
    w = w.to(torch.bfloat16).float()
    wt = fused_conv.ffma_weights(w)
    assert wt.dtype == torch.float32 and wt.shape == (10 * C, 8) and wt.is_contiguous()
    assert torch.equal(wt[:, :Co], w.reshape(Co, -1).t()) and not wt[:, Co:].any()
    wp = fused_conv.tensor_core_weights(w)
    Cp = -(-C // 8) * 8
    assert wp.dtype == torch.bfloat16 and wp.shape == (Co, 10 * Cp) and wp.is_contiguous()
    rows = wp.float().view(Co, Cp // 8, 5, 2, 8)  # [o][chunk][kf][kt][channel]
    want = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, Cp - C)).view(Co, Cp // 8, 8, 5, 2)
    assert torch.equal(rows, want.permute(0, 1, 3, 4, 2))
    torch.testing.assert_close(_chunked_conv(x, wp, b), fused_conv.reference(x, w, b),
                               atol=1e-5, rtol=0)


# --- the tiny DCCRN with use_pallas_conv=True ------------------------------


def _cfgs(use_pallas_conv=True):
    return (
        JConfig(dccrn=JDccrnConfig(**TINY), use_pallas_conv=use_pallas_conv,
                train=JTrainConfig(learning_rate=LR)),
        Config(dccrn=DccrnConfig(**TINY), use_pallas_conv=use_pallas_conv,
               train=TrainConfig(learning_rate=LR)),
    )


@pytest.fixture(scope="module")
def tiny():
    _, cfg = _cfgs()
    params, bstats = random_dccrn_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    clean = (rng.standard_normal((2, 4000)) * 0.1).astype(np.float32)
    noisy = (clean + rng.standard_normal((2, 4000)) * 0.05).astype(np.float32)
    return types.SimpleNamespace(params=params, bstats=bstats, noisy=noisy, clean=clean)


def _port(tiny, use_pallas_conv=True):
    _, cfg = _cfgs(use_pallas_conv)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(dccrn_state_dict_from_jax(tiny.params, tiny.bstats, cfg), strict=True)
    return cfg, model


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np_sd(tree, bstats, cfg):
    np_tree = jax.tree.map(np.array, tree)
    return {k: v.numpy()
            for k, v in dccrn_state_dict_from_jax(np_tree, jax.tree.map(np.array, bstats),
                                                  cfg).items()}


def test_dccrn_forward_and_eval_step_match_jax_and_the_default_path(tiny):
    """The fused encoder (the same parameter names: the carried-over state
    dict loads with strict=True) against the JAX model with its Pallas
    conv, and against the port's default block-form path: outputs and the
    enhanced waveform at atol 1e-4, the SDR loss at rtol 1e-4."""
    jcfg, _ = _cfgs()
    cfg, model = _port(tiny)
    assert all(stage[0].fused for stage in model.encoder)
    variables = {"params": tiny.params, "batch_stats": tiny.bstats}
    jmodel = jbuild_model(jcfg)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(tiny.noisy))
    _, default = _port(tiny, use_pallas_conv=False)
    with torch.inference_mode():
        got = model(torch.from_numpy(tiny.noisy))
        plain = default(torch.from_numpy(tiny.noisy))
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=1e-4)

    body = eval_step_body(jcfg, jmodel)
    want_m, want_wav = jax.jit(lambda p, bs, n, c: body(
        types.SimpleNamespace(params=p, batch_stats=bs), n, c))(
        tiny.params, tiny.bstats, jnp.asarray(tiny.noisy), jnp.asarray(tiny.clean))
    got_m, got_wav = eval_step(cfg, model, tiny.noisy, tiny.clean)
    np.testing.assert_allclose(got_m["loss"].item(), float(want_m["loss"]), rtol=1e-4)
    np.testing.assert_allclose(got_wav.numpy(), np.asarray(want_wav), atol=1e-4)


def test_train_gradients_and_step_match_jax(tiny):
    """In train mode, the SDR loss at rtol 1e-4 and each gradient within
    1e-3 x the JAX leaf's max, except the conv biases that feed a
    BatchNorm (exact gradient 0: both below 1e-5 x the largest gradient);
    then one ``train_step`` against ``make_train_step`` (Adam, lr 1e-3):
    the loss at rtol 1e-4, running statistics at atol 1e-5, every
    parameter within 2 lr (Adam's first step moves each by about
    lr * sign(g), which flips where a gradient is at roundoff)."""
    jcfg, cfg = _cfgs()
    jmodel = jbuild_model(jcfg)

    def loss_fn(params):
        loss, _ = _loss_and_outputs(jcfg, jmodel, params, _jtree(tiny.bstats),
                                    jnp.asarray(tiny.noisy), jnp.asarray(tiny.clean),
                                    train=True, dropout_rng=None)
        return loss

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(_jtree(tiny.params))
    want = _np_sd(grads, tiny.bstats, cfg)
    model, opt = create_train_state(cfg, dccrn_state_dict_from_jax(tiny.params, tiny.bstats, cfg),
                                    device="cpu")
    model.train()
    loss = main_loss(cfg.loss, model(torch.from_numpy(tiny.noisy))[2],
                     torch.from_numpy(tiny.clean))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    sd = model.state_dict()
    cancelled = {k for k in sd if k.endswith("_conv.bias")
                 and k.rsplit(".", 3)[0] + ".1.running_mean" in sd}
    scale = max(np.abs(want[k]).max() for k in got)
    for k, g in got.items():
        if k in cancelled:
            assert max(np.abs(g).max(), np.abs(want[k]).max()) <= 1e-5 * scale, k
        else:
            assert np.abs(g - want[k]).max() <= 1e-3 * np.abs(want[k]).max(), k

    tx = jmake_optimizer(jcfg)
    params = _jtree(tiny.params)
    state = TrainState(step=0, params=params, batch_stats=_jtree(tiny.bstats),
                       opt_state=tx.init(params), tx=tx)
    state, metrics = make_train_step(jcfg, jmodel)(
        state, jnp.asarray(tiny.noisy), jnp.asarray(tiny.clean), jax.random.PRNGKey(0))
    want = _np_sd(state.params, state.batch_stats, cfg)
    model, opt = create_train_state(cfg, dccrn_state_dict_from_jax(tiny.params, tiny.bstats, cfg),
                                    device="cpu")
    got_m = train_step(cfg, model, opt, tiny.noisy, tiny.clean)
    np.testing.assert_allclose(got_m["loss"].item(), float(metrics["loss"]), rtol=1e-4)
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k], atol=1e-5, err_msg=k)
    for k, p in model.named_parameters():
        assert np.abs(p.detach().numpy() - want[k]).max() <= 2 * LR, k
