"""The PyTorch port's CRN slice and DCCRN's real-LSTM bottleneck
(se_tpu_torch) against the JAX package on the CPU at a tiny width: the
in-projection LSTM scan (K2) forward and backward, ``rnn.lstm``, the weight
carry-over, the CRN forward in mask and direct modes, its gradients and
train steps, the tiny DCCRN with ``lstm="real"``, and the enhance CLI.

The JAX side runs its Pallas kernels (``use_pallas_lstm="on"``) in
interpret mode, as the JAX package's own tests do on the CPU.  Inputs come
from numpy seeds and go through both packages; the JAX weights are numpy
trees (``random_crn_params``, ``random_dccrn_params``) handed to flax's
``apply`` directly, their layout checked against flax's ``init``."""

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
from se_tpu.ops import pallas_lstm
from se_tpu.ops import rnn as jrnn
from se_tpu.train.state import TrainState, make_optimizer as jmake_optimizer
from se_tpu.train.steps import _loss_and_outputs, make_train_step
from se_tpu.utils.torch_export import export_reference_state_dict, save_reference_checkpoint

from se_tpu_torch.config import Config, CrnConfig, DccrnConfig, TrainConfig
from se_tpu_torch.data.wav import read_wav, write_wav
from se_tpu_torch.enhance import enhance_batch, main as enhance_main
from se_tpu_torch.losses import main_loss
from se_tpu_torch.models import build_model
from se_tpu_torch.models.layers import TorchLSTM
from se_tpu_torch.ops import fused_lstm_inproj
from se_tpu_torch.ops import rnn as trnn
from se_tpu_torch.ops.fused_lstm_inproj import (
    fused_lstm_scan_inproj,
    fused_lstm_scan_inproj_backward,
    fused_lstm_scan_inproj_backward_reference,
    fused_lstm_scan_inproj_reference,
)
from se_tpu_torch.train.state import create_train_state
from se_tpu_torch.train.steps import train_step
from se_tpu_torch.utils.weights import (
    load_reference_checkpoint,
    random_crn_params,
    random_dccrn_params,
    save_reference_checkpoint as tsave,
    state_dict_from_jax,
)

TINY_KN = (8, 16, 16)
# CRN: C x D after three stages = 8 x 32 = 256
TINY_CRN = dict(rnn_input_size=256, rnn_units=32)
LR = 1e-3
GRAD_NAMES = ("dx", "dw_ih_t", "dbias", "dw_hh_t", "dh0", "dc0")


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


# --- K2: the in-projection scan ----------------------------------------------


def _inproj_case(T, L, Bb, In, H, seed=0):
    """Forward inputs (torch's init range, nonzero h0 and c0) and seeded
    cotangents of (ys, hT, cT)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    k = 1 / np.sqrt(H)
    return (
        rng.standard_normal((T, L, Bb, In)).astype(f),
        rng.uniform(-k, k, (L, In, 4 * H)).astype(f),
        rng.uniform(-2 * k, 2 * k, (L, 4 * H)).astype(f),
        rng.uniform(-k, k, (L, H, 4 * H)).astype(f),
        (rng.standard_normal((L, Bb, H)) * 0.5).astype(f),
        (rng.standard_normal((L, Bb, H)) * 0.5).astype(f),
    ), (
        rng.standard_normal((T, L, Bb, H)).astype(f),
        rng.standard_normal((L, Bb, H)).astype(f),
        rng.standard_normal((L, Bb, H)).astype(f),
    )


def _torch_vjp(fn, inputs, cots):
    """``fn``'s outputs and the gradients of its six inputs for ``cots``."""
    args = [_t(a).requires_grad_() for a in inputs]
    ys, (hT, cT) = fn(*args)
    dys, dhT, dcT = map(_t, cots)
    total = (ys * dys).sum() + (hT * dhT).sum() + (cT * dcT).sum()
    return (ys, hT, cT), torch.autograd.grad(total, args)


@pytest.mark.parametrize("shape", [(10, 1, 12, 8, 16), (9, 2, 5, 8, 16)], ids=["L1", "L2-ragged"])
def test_inproj_scan_matches_pallas_vjp(shape):
    """The port's Function (plain forward with the stash, plain backward) on
    the CPU against ``jax.vjp`` of the Pallas kernel run in interpret mode:
    ys, hT, cT and the six input gradients at atol 1e-5, rtol 1e-4 (the
    same f32 arithmetic summed in another order; dW sums T x Bb rows)."""
    inputs, cots = _inproj_case(*shape)
    (ys_j, (hT_j, cT_j)), vjp = jax.vjp(pallas_lstm.fused_lstm_scan_inproj,
                                        *map(jnp.asarray, inputs))
    dys, dhT, dcT = map(jnp.asarray, cots)
    want = vjp((dys, (dhT, dcT)))
    outs, got = _torch_vjp(fused_lstm_scan_inproj, inputs, cots)
    for name, g, w in zip(("ys", "hT", "cT"), outs, (ys_j, hT_j, cT_j)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    for name, g, w in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("cotangents", ["all", "ys-only"])
def test_inproj_plain_backward_matches_autograd_of_plain_forward(cotangents):
    """The plain backward against torch's autograd of the plain recurrence,
    atol 1e-5; with ``dhT``/``dcT`` given as None when only ``ys`` is used,
    as CRN uses it."""
    inputs, cots = _inproj_case(6, 2, 3, 7, 8, seed=1)
    if cotangents == "ys-only":
        cots = (cots[0], np.zeros_like(cots[1]), np.zeros_like(cots[2]))
    _, want = _torch_vjp(fused_lstm_scan_inproj_reference, inputs, cots)
    args = list(map(_t, inputs))
    ys, cs, _, _ = fused_lstm_inproj._reference_forward(*args, need_cs=True)
    tail = (_t(cots[0]), None, None) if cotangents == "ys-only" else map(_t, cots)
    got = fused_lstm_scan_inproj_backward(*args, ys, cs, *tail)
    for name, g, w in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, err_msg=name)


def test_inproj_wrapper_on_cpu_runs_plain_without_counting(monkeypatch):
    """CPU tensors take the plain versions and count no launch; the forward
    writes the stash only when an input needs a gradient (not under
    ``no_grad`` or ``inference_mode``), and the Function then saves
    ``cs [T, L, Bb, H]``; bad inputs raise."""
    inputs, cots = _inproj_case(5, 1, 3, 6, 8, seed=2)
    args = list(map(_t, inputs))
    before = fused_lstm_scan_inproj.launches, fused_lstm_scan_inproj_backward.launches
    ys, (hT, cT) = fused_lstm_scan_inproj(*args)
    ys_r, (hT_r, cT_r) = fused_lstm_scan_inproj_reference(*args)
    assert torch.equal(ys, ys_r) and torch.equal(hT, hT_r) and torch.equal(cT, cT_r)
    _, cs, _, _ = fused_lstm_inproj._reference_forward(*args, need_cs=True)
    got = fused_lstm_scan_inproj_backward(*args, ys, cs, *map(_t, cots))
    want = fused_lstm_scan_inproj_backward_reference(*args, ys, cs, *map(_t, cots))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (fused_lstm_scan_inproj.launches,
            fused_lstm_scan_inproj_backward.launches) == before

    asked = []
    real = fused_lstm_inproj._reference_forward

    def spy(*a):
        asked.append(a[6])  # need_cs, after the six inputs
        return real(*a)

    monkeypatch.setattr(fused_lstm_inproj, "_reference_forward", spy)
    leaves = [_t(a).requires_grad_() for a in inputs]
    with torch.no_grad():
        fused_lstm_scan_inproj(*leaves)
    with torch.inference_mode():
        fused_lstm_scan_inproj(*args)
    fused_lstm_scan_inproj(*args)
    assert asked == [False, False, False]
    ys, _ = fused_lstm_scan_inproj(*leaves)
    assert asked[-1] is True
    saved = ys.grad_fn.saved_tensors
    assert len(saved) == 8 and tuple(saved[-1].shape) == (5, 1, 3, 8)

    with pytest.raises(TypeError):
        fused_lstm_scan_inproj(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        fused_lstm_scan_inproj(args[0][:, :, :, :-1], *args[1:])
    with pytest.raises(ValueError):
        fused_lstm_scan_inproj(*args[:2], args[2][:, :-1], *args[3:])


def test_rnn_lstm_matches_jax():
    """``rnn.lstm`` on a transposed (non-contiguous) input, from zeros and
    from a given state, against JAX ``rnn.lstm(use_pallas=True)``: outputs,
    final state and the gradients of the four weights at atol 1e-5."""
    rng = np.random.default_rng(3)
    T, B, In, H = 8, 3, 10, 12
    k = 1 / np.sqrt(H)
    w = [rng.uniform(-k, k, s).astype(np.float32)
         for s in ((4 * H, In), (4 * H, H), (4 * H,), (4 * H,))]
    x = rng.standard_normal((B, T, In)).astype(np.float32)
    h0, c0 = (rng.standard_normal((2, B, H)) * 0.5).astype(np.float32)
    dys = rng.standard_normal((T, B, H)).astype(np.float32)

    for state in (None, (h0, c0)):
        def jloss(params, xx):
            ys, (hT, cT) = jrnn.lstm(jrnn.LstmParams(*params), xx.swapaxes(0, 1),
                                     *(map(jnp.asarray, state) if state else ()),
                                     use_pallas=True)
            return jnp.sum(ys * dys) + jnp.sum(hT) + jnp.sum(cT), (ys, hT, cT)

        (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(
            [jnp.asarray(a) for a in w], jnp.asarray(x))
        params = [_t(a).requires_grad_() for a in w]
        ys, (hT, cT) = trnn.lstm(trnn.LstmParams(*params), _t(x).transpose(0, 1),
                                 *(map(_t, state) if state else ()))
        loss = (ys * _t(dys)).sum() + hT.sum() + cT.sum()
        grads = torch.autograd.grad(loss, params)
        for g, want in zip((ys, hT, cT, *grads), (*jout, *jgrads)):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(want), atol=1e-5)
    # a bf16 input takes the bf16-stream form (tests/test_torch_bf16.py)
    ys16, _ = trnn.lstm(trnn.LstmParams(*map(_t, w)), _t(x).transpose(0, 1).bfloat16())
    assert ys16.dtype == torch.bfloat16


# --- weights -------------------------------------------------------------------


def _cfgs(model="CRN", mode="E", accum=1, lstm="real"):
    loss = "MSE" if model == "CRN" else "SDR"
    common = dict(model=model, loss=loss, masking_mode=mode, lstm=lstm)
    return (
        JConfig(**common, dccrn=JDccrnConfig(kernel_num=TINY_KN, rnn_units=32),
                crn=JCrnConfig(**TINY_CRN), use_pallas_lstm="on",
                train=JTrainConfig(learning_rate=LR, grad_accum=accum)),
        Config(**common, dccrn=DccrnConfig(kernel_num=TINY_KN, rnn_units=32),
               crn=CrnConfig(**TINY_CRN), train=TrainConfig(learning_rate=LR, grad_accum=accum)),
    )


@pytest.fixture(scope="module")
def tiny():
    _, crn_cfg = _cfgs("CRN")
    _, dccrn_cfg = _cfgs("DCCRN")
    rng = np.random.default_rng(0)
    clean = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    noisy = (clean + rng.standard_normal((2, 8000)) * 0.05).astype(np.float32)
    return types.SimpleNamespace(
        trees={"CRN": random_crn_params(crn_cfg, seed=0),
               "DCCRN": random_dccrn_params(dccrn_cfg, seed=0)},
        noisy=noisy, clean=clean,
    )


def _port(tiny, cfg):
    model, opt = create_train_state(cfg, state_dict_from_jax(*tiny.trees[cfg.model], cfg),
                                    device="cpu")
    return model, opt


@pytest.mark.parametrize("model", ["CRN", "DCCRN"])
def test_random_tree_has_flax_layout(tiny, model):
    jcfg, _ = _cfgs(model)
    shapes = jax.eval_shape(
        lambda: jbuild_model(jcfg).init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4000)), train=False
        )
    )
    params, bstats = tiny.trees[model]
    want = jax.tree.map(lambda s: s.shape, dict(shapes))
    assert jax.tree.map(np.shape, {"params": params, "batch_stats": bstats}) == want


@pytest.mark.parametrize("model", ["CRN", "DCCRN"])
def test_state_dict_equals_jax_export(tiny, model, tmp_path):
    """Key for key and value for value, then a strict load; the blob the JAX
    exporter writes reaches the port unchanged."""
    jcfg, cfg = _cfgs(model)
    params, bstats = tiny.trees[model]
    want = export_reference_state_dict(params, bstats, jcfg)
    got = state_dict_from_jax(params, bstats, cfg)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    build_model(cfg, device="cpu").load_state_dict(got, strict=True)
    path = save_reference_checkpoint(str(tmp_path / "c.pt"), params, bstats, jcfg, 3)
    sd, epoch = load_reference_checkpoint(path)
    assert epoch == 3 and sd.keys() == got.keys()
    assert all(torch.equal(sd[k], got[k]) for k in sd)


# --- the tiny models against JAX ---------------------------------------------


@pytest.mark.parametrize("model,mode", [("CRN", "E"), ("CRN", "Direct(None make)"),
                                        ("DCCRN", "E")])
def test_forward_matches_jax(tiny, model, mode):
    """Every output at atol 1e-4 (the waveform, the estimated or direct
    magnitude, the target magnitude): f32 through three conv stages, the
    LSTM and three transposed convs."""
    jcfg, cfg = _cfgs(model, mode)
    params, bstats = tiny.trees[model]
    args = (tiny.noisy, tiny.clean) if model == "CRN" else (tiny.noisy,)
    want = jax.jit(lambda *a: jbuild_model(jcfg).apply(
        {"params": params, "batch_stats": bstats}, *a, train=False))(*map(jnp.asarray, args))
    m, _ = _port(tiny, cfg)
    with torch.inference_mode():
        got = m(*map(_t, args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def _running_stats(model):
    return {k: v.numpy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _cancelled_by_batch_norm(model):
    """The conv biases that feed a train-mode BatchNorm: their exact gradient
    is 0, and both packages give roundoff there."""
    sd = model.state_dict()
    return {k for k in sd if k.endswith("conv.bias")
            and k.rsplit(".", 3)[0] + ".1.running_mean" in sd}


def _params_sd(tree, bstats, cfg):
    return {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.array, tree), jax.tree.map(np.array, bstats), cfg).items()}


def test_crn_train_gradients_and_running_stats_match_jax(tiny):
    """MSE loss at rtol 1e-4; each gradient leaf within 1e-3 of its JAX max,
    the BatchNorm-cancelled conv biases both below 1e-5 of the largest
    gradient; running statistics at atol 1e-5."""
    jcfg, cfg = _cfgs("CRN")
    params, bstats = tiny.trees["CRN"]
    jmodel = jbuild_model(jcfg)

    def loss_fn(p):
        loss, (_, _, new_bs) = _loss_and_outputs(
            jcfg, jmodel, p, jax.tree.map(jnp.asarray, bstats), jnp.asarray(tiny.noisy),
            jnp.asarray(tiny.clean), train=True, dropout_rng=None)
        return loss, new_bs

    (want_loss, new_bs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    want = _params_sd(grads, new_bs, cfg)

    model, _ = _port(tiny, cfg)
    model.train()
    _, _, out = model(_t(tiny.noisy))
    loss = main_loss(cfg.loss, out, _t(tiny.clean))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    cancelled = _cancelled_by_batch_norm(model)
    assert len(cancelled) == 5
    scale = max(np.abs(want[k]).max() for k in got)
    for k, g in got.items():
        if k in cancelled:
            assert max(np.abs(g).max(), np.abs(want[k]).max()) <= 1e-5 * scale, k
        else:
            err = np.abs(g - want[k]).max()
            assert err <= 1e-3 * np.abs(want[k]).max(), (k, err, np.abs(want[k]).max())
    for k, v in _running_stats(model).items():
        np.testing.assert_allclose(v, want[k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("model,mode,accum", [
    ("CRN", "E", 1), ("CRN", "E", 2), ("CRN", "Direct(None make)", 1), ("DCCRN", "E", 1),
], ids=["crn-masking", "crn-masking-accum2", "crn_direct", "dccrn-real"])
def test_train_step_matches_jax(tiny, model, mode, accum):
    """One ``train_step`` against the JAX package's jitted ``make_train_step``
    (Adam, lr 1e-3): loss at rtol 1e-4, running statistics at atol 1e-5,
    every parameter within 2 lr and at most 0.1% of entries off by more than
    1e-5 outside the BatchNorm-cancelled conv biases (Adam's first step is
    about lr * sign(g), and a roundoff-level gradient's sign can flip).  The
    LSTM's two bias gradients are separate tensors."""
    jcfg, cfg = _cfgs(model, mode, accum)
    params, bstats = tiny.trees[model]
    jmodel = jbuild_model(jcfg)
    tx = jmake_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=0, params=jp, batch_stats=jax.tree.map(jnp.asarray, bstats),
                       opt_state=tx.init(jp), tx=tx)
    state, metrics = make_train_step(jcfg, jmodel)(
        state, jnp.asarray(tiny.noisy), jnp.asarray(tiny.clean), jax.random.PRNGKey(0))
    want = _params_sd(state.params, state.batch_stats, cfg)

    m, opt = _port(tiny, cfg)
    got_m = train_step(cfg, m, opt, tiny.noisy, tiny.clean)
    np.testing.assert_allclose(got_m["loss"].item(), float(metrics["loss"]), rtol=1e-4)
    for k, v in _running_stats(m).items():
        np.testing.assert_allclose(v, want[k], atol=1e-5, err_msg=k)
    cancelled = _cancelled_by_batch_norm(m)
    deltas = {k: np.abs(p.detach().numpy() - want[k]).ravel() for k, p in m.named_parameters()}
    assert max(d.max() for d in deltas.values()) <= 2 * LR
    rest = np.concatenate([d for k, d in deltas.items() if k not in cancelled])
    assert np.mean(rest > 1e-5) <= 1e-3, np.mean(rest > 1e-5)
    lstm = m.enhance
    assert lstm.bias_ih_l0.grad.data_ptr() != lstm.bias_hh_l0.grad.data_ptr()
    assert torch.equal(lstm.bias_ih_l0.grad, lstm.bias_hh_l0.grad)


def test_unported_variants_raise():
    """CRN without skip connections and DCCRN's direct mapping are ported
    (held to the JAX package in ``tests/test_torch_variants.py``): both
    build.  Train-mode dropout raises without a generator."""
    _, cfg = _cfgs("CRN")
    noskip = build_model(cfg.replace(skip_type=False), device="cpu")
    assert "decoder.0.0.weight" in noskip.state_dict()
    build_model(cfg.replace(model="DCCRN", masking_mode="Direct(None make)"), device="cpu")
    lstm = TorchLSTM(4, 3, num_layers=2, dropout=0.5, generator=torch.Generator())
    with pytest.raises(ValueError, match="Generator"):  # train-mode dropout needs one
        lstm.train()(torch.zeros(2, 1, 4))
    lstm.train()(torch.zeros(2, 1, 4), torch.Generator().manual_seed(0))
    lstm.eval()(torch.zeros(2, 1, 4))  # dropout is off in eval mode


def test_enhance_cli_crn_matches_in_process(tiny, tmp_path):
    """``python -m se_tpu_torch.enhance --model CRN --device cpu`` (run in
    process) on a file of whole seconds and a ragged one, against
    ``enhance_batch`` on the zero-padded input, within 2 int16 LSBs."""
    cfg = Config(model="CRN", loss="MSE")
    sd = state_dict_from_jax(*random_crn_params(cfg, seed=1), cfg)
    ckpt = tsave(str(tmp_path / "c.pt"), sd)
    rng = np.random.default_rng(4)
    lengths = {"a.wav": 16000, "b.wav": 7100}
    for name, L in lengths.items():
        write_wav(str(tmp_path / name), rng.standard_normal(L) * 0.1, cfg.stft.fs)
    enhance_main(["--checkpoint", ckpt, "--model", "CRN", "--device", "cpu",
                  *[str(tmp_path / n) for n in lengths], "--out-dir", str(tmp_path / "out")])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    for name, L in lengths.items():
        x = read_wav(str(tmp_path / name))[0].astype(np.float32)
        want = enhance_batch(model, np.pad(x, (0, 16000 - L))[None], device="cpu")[0, :L]
        got = read_wav(str(tmp_path / "out" / name))[0]
        assert got.shape == (L,)
        np.testing.assert_allclose(got, want.numpy(), atol=2 / 32768)
