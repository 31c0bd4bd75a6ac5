"""The PyTorch port's bf16 compute (se_tpu_torch, ``compute_dtype=
"bfloat16"``) against the JAX package on the CPU at a tiny width: the
bf16-stream forms of the LSTM scans K1 and K2 (plain versions) against
the Pallas kernels run in interpret mode, ``rnn.lstm`` against both of the
reference's bf16 forms, the DCCRN (complex and real LSTM) and CRN forwards,
DCCRN's gradients and train steps, CRN's eval and training, Adam with a
bf16 first moment, the enhance CLI, and what a bf16 form refuses.

The JAX side runs its Pallas LSTM kernels (``use_pallas_lstm="on"``, the
form ``"auto"`` takes on a TPU) and is jitted; its weights are numpy trees
(``random_crn_params``, ``random_dccrn_params``).  Inputs come from numpy
seeds and go through both packages, cast to bf16 by each (both round to
nearest even, so the bf16 inputs are the same bits)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from se_tpu.config import (
    Config as JConfig,
    CrnConfig as JCrnConfig,
    DccrnConfig as JDccrnConfig,
)
from se_tpu.models import build_model as jbuild_model
from se_tpu.ops import pallas_lstm
from se_tpu.ops import rnn as jrnn
from se_tpu.train.steps import _loss_and_outputs

from se_tpu_torch.config import Config, CrnConfig, DccrnConfig, TrainConfig
from se_tpu_torch.data.wav import read_wav, write_wav
from se_tpu_torch.enhance import main as enhance_main
from se_tpu_torch.losses import main_loss
from se_tpu_torch.models import build_model
from se_tpu_torch.ops import fused_conv, fused_gru_inproj, fused_lstm, fused_lstm_inproj
from se_tpu_torch.ops import rnn as trnn
from se_tpu_torch.train.state import AdamLowPrecisionMu, create_train_state, make_optimizer
from se_tpu_torch.train.steps import eval_step, train_step
from se_tpu_torch.utils.weights import (
    random_crn_params,
    random_dccrn_params,
    save_reference_checkpoint,
    state_dict_from_jax,
)

BF16 = jnp.bfloat16
TINY_KN = (8, 16, 16)
TINY_CRN = dict(rnn_input_size=256, rnn_units=32)
# f32 outputs of the bf16 forms (hT, cT and the weight and state
# gradients): the same f32 arithmetic as the JAX kernel, summed in another
# order, as the f32 forms' tests hold them (tests/test_torch_crn.py)
F32_ATOL, F32_RTOL = 1e-5, 1e-4
# bf16 outputs (ys, dx): a sum taken in another order can tip a rounding, so
# each element within one bf16 ulp of its magnitude; measured 0 ulps here
BF16_ULPS = 1.0
# port bf16 vs JAX bf16 waveforms: at least this many times nearer, by mean
# |difference|, than either is to its f32 waveform (measured 9.8x DCCRN,
# 29x DCCRN real LSTM, 250x CRN)
SEPARATION = 4
# bf16 vs f32 waveform, the JAX package's own gate
# (tests/test_model_variants.py::test_dccrn_bf16_compute_close_to_f32)
BF16_VS_F32_MEAN = 5e-3


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


def _ulps(got, want) -> float:
    """max over elements of |got - want| in bf16 ulps of max(|got|, |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.ldexp(np.float32(1.0), np.frexp(mag)[1] - 8)  # 2^(e-8): [2^-8, 2^-7] of mag
    return float(np.max(np.abs(got - want) / np.maximum(ulp, np.finfo(np.float32).tiny)))


def _case(seed, T, L, Bb, H, In=None):
    """f32 inputs (torch's init range, nonzero h0 and c0) and cotangents;
    the stream (x_proj, or x with In) and dys are cast to bf16 by each
    side."""
    rng = np.random.default_rng(seed)
    f, k = np.float32, 1 / np.sqrt(H)
    stream = rng.standard_normal((T, L, Bb, In or 4 * H)).astype(f)
    weights = [rng.uniform(-k, k, (L, H, 4 * H)).astype(f)]
    if In:
        weights = [rng.uniform(-k, k, (L, In, 4 * H)).astype(f),
                   rng.uniform(-2 * k, 2 * k, (L, 4 * H)).astype(f)] + weights
    state = [(rng.standard_normal((L, Bb, H)) * 0.5).astype(f) for _ in range(2)]
    cots = [rng.standard_normal(s).astype(f) for s in ((T, L, Bb, H), (L, Bb, H), (L, Bb, H))]
    return [stream, *weights, *state], cots


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_bf16_stream_plain_versions_match_pallas_vjp(kernel):
    """The port's bf16-stream forms on the CPU (the plain versions) against
    the Pallas kernels in interpret mode on the same bf16 stream.  Forward:
    ys bf16 within one bf16 ulp, hT and cT at the f32 forms' tolerance.
    Backward, on the Pallas forward's own residuals (ys, cs) and the same
    bf16 dys: the stream's gradient bf16 within one bf16 ulp, the f32
    gradients at the f32 forms' tolerance.  (Fed its own forward's ys, the
    backward would inherit every ys rounding that an f32 sum in another
    order tipped: measured 8e-5 on a dW_hh entry of 0.1.)  Through autograd
    the gradients keep their inputs' dtypes."""
    if kernel == "K1":
        jfwd, jbwd = pallas_lstm._fused_fwd, pallas_lstm._fused_bwd
        tfn, tbwd = fused_lstm.fused_lstm_scan, fused_lstm.fused_lstm_scan_backward
        inputs, cots = _case(0, 10, 2, 5, 16)
    else:
        jfwd, jbwd = pallas_lstm._inproj_fwd, pallas_lstm._inproj_bwd
        tfn = fused_lstm_inproj.fused_lstm_scan_inproj
        tbwd = fused_lstm_inproj.fused_lstm_scan_inproj_backward
        inputs, cots = _case(1, 9, 2, 5, 16, In=7)
    jin = [jnp.asarray(inputs[0]).astype(BF16), *map(jnp.asarray, inputs[1:])]
    (ys_j, (hT_j, cT_j)), res = jfwd(*jin)
    jcots = (jnp.asarray(cots[0]).astype(BF16), (jnp.asarray(cots[1]), jnp.asarray(cots[2])))
    grads_j = jbwd(res, jcots)
    assert ys_j.dtype == grads_j[0].dtype == BF16

    args = [_t(inputs[0]).bfloat16().requires_grad_()] + [_t(a).requires_grad_() for a in inputs[1:]]
    ys, (hT, cT) = tfn(*args)
    assert ys.dtype == torch.bfloat16 and hT.dtype == cT.dtype == torch.float32
    assert _ulps(ys.detach().float(), ys_j) <= BF16_ULPS
    for got, want in ((hT, hT_j), (cT, cT_j)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=F32_ATOL, rtol=F32_RTOL)

    t_res = [_t(np.asarray(r, np.float32)) for r in res]
    t_res[0], t_res[-2] = t_res[0].bfloat16(), t_res[-2].bfloat16()  # the stream, ys
    grads = tbwd(*t_res, _t(cots[0]).bfloat16(), _t(cots[1]), _t(cots[2]))
    assert grads[0].dtype == torch.bfloat16
    assert _ulps(grads[0].float(), grads_j[0]) <= BF16_ULPS
    for got, want in zip(grads[1:], grads_j[1:]):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL, rtol=F32_RTOL)

    auto = torch.autograd.grad((ys, hT, cT), args,
                               (_t(cots[0]).bfloat16(), _t(cots[1]), _t(cots[2])))
    assert [g.dtype for g in auto] == [a.dtype for a in args]


# rnn.lstm (K2's form) against the reference's scan form, which rounds the
# projection to bf16 where K2 projects the upcast x in f32 (ROADMAP.md,
# Queue 3).  Measured on this case: 52% of ys apart, max |diff| 1.95e-3,
# mean 3.2e-4 (T=40, B=4, In=64, H=32: 3.9e-3 and 3.5e-4), against 0 from
# the Pallas form; the f32 layer is 2.5e-4 (mean) from the Pallas form and
# 4.2e-4 from the scan form.  Held at twice the measured gap.
SCAN_FORM_MAX, SCAN_FORM_MEAN = 4e-3, 7e-4


def test_rnn_lstm_bf16_is_the_pallas_form():
    """``rnn.lstm`` on a bf16 input against JAX ``rnn.lstm`` in both its
    bf16 forms: the Pallas form (``use_pallas=True``; ys within one bf16
    ulp, hT and cT f32 at the f32 tolerance) and the scan form
    (``use_pallas=False``; the gap that Queue 3 records).  The weights'
    gradients against the Pallas form's."""
    rng = np.random.default_rng(3)
    T, B, In, H = 8, 3, 10, 12
    k = 1 / np.sqrt(H)
    w = [rng.uniform(-k, k, s).astype(np.float32)
         for s in ((4 * H, In), (4 * H, H), (4 * H,), (4 * H,))]
    x = rng.standard_normal((T, B, In)).astype(np.float32)
    dys = rng.standard_normal((T, B, H)).astype(np.float32)

    def jloss(params, pallas):
        ys, (hT, cT) = jrnn.lstm(jrnn.LstmParams(*params), jnp.asarray(x).astype(BF16),
                                 use_pallas=pallas)
        loss = jnp.sum(ys.astype(jnp.float32) * dys) + jnp.sum(hT) + jnp.sum(cT)
        return loss, (ys, hT, cT)

    jw = [jnp.asarray(a) for a in w]
    (_, (ys_p, hT_p, cT_p)), grads_p = jax.value_and_grad(jloss, has_aux=True)(jw, True)
    _, (ys_s, _, _) = jloss(jw, False)

    params = [_t(a).requires_grad_() for a in w]
    ys, (hT, cT) = trnn.lstm(trnn.LstmParams(*params), _t(x).bfloat16())
    assert ys.dtype == torch.bfloat16 and hT.dtype == cT.dtype == torch.float32
    grads = torch.autograd.grad((ys.float() * _t(dys)).sum() + hT.sum() + cT.sum(), params)
    assert _ulps(ys.detach().float(), ys_p) <= BF16_ULPS
    for got, want in zip((hT, cT, *grads), (hT_p, cT_p, *grads_p)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=F32_ATOL, rtol=F32_RTOL)
    gap = np.abs(ys.detach().float().numpy() - np.asarray(ys_s, np.float32))
    assert 0 < gap.mean() <= SCAN_FORM_MEAN and gap.max() <= SCAN_FORM_MAX


# --- the models ----------------------------------------------------------------


def _cfgs(model="DCCRN", lstm="complex", dtype="bfloat16"):
    common = dict(model=model, lstm=lstm, loss="MSE" if model == "CRN" else "SDR",
                  compute_dtype=dtype)
    return (
        JConfig(**common, dccrn=JDccrnConfig(kernel_num=TINY_KN, rnn_units=32),
                crn=JCrnConfig(**TINY_CRN), use_pallas_lstm="on"),
        Config(**common, dccrn=DccrnConfig(kernel_num=TINY_KN, rnn_units=32),
               crn=CrnConfig(**TINY_CRN), train=TrainConfig(learning_rate=1e-3)),
    )


def _tree(cfg):
    """The seed-0 JAX tree of ``cfg``'s model (its compute dtype aside)."""
    return _tree_of(cfg.model, cfg.lstm)


@functools.lru_cache(maxsize=None)
def _tree_of(model, lstm):
    cfg = _cfgs(model, lstm)[1]
    return (random_crn_params if model == "CRN" else random_dccrn_params)(cfg, 0)


def _jit_as_written(fn, *args):
    """``fn(*args)`` jitted with every bf16 value rounded as written: by
    default XLA on the CPU keeps a chain of bf16 operations in f32
    (``xla_allow_excess_precision``), which in the train-mode BatchNorm's
    variance moves the SDR loss by 3e-3 relative."""
    args = jax.tree.map(jnp.asarray, args)
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args)


def _batch(seed=0, n=8000):
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((2, n)) * 0.1).astype(np.float32)
    return (clean + rng.standard_normal((2, n)) * 0.05).astype(np.float32), clean


def _port(cfg):
    return create_train_state(cfg, state_dict_from_jax(*_tree(cfg), cfg), device="cpu")


@pytest.mark.parametrize("model,lstm", [("DCCRN", "complex"), ("DCCRN", "real"),
                                        ("CRN", "real")])
def test_bf16_forward_reproduces_the_jax_bf16_path(model, lstm):
    """The waveform of the port's bf16 forward against the JAX package's
    bf16 forward (Pallas LSTMs): at least SEPARATION times nearer, by mean
    |difference|, than either is to its own f32 waveform, so the port
    reproduces the bf16 path and not just something near f32; and within the
    JAX package's own bf16-vs-f32 gate of its f32 waveform."""
    params, bstats = _tree(_cfgs(model, lstm)[1])
    noisy, clean = _batch()
    args = (noisy, clean) if model == "CRN" else (noisy,)
    wavs = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfgs(model, lstm, dtype)
        wavs["jax", dtype] = np.asarray(_jit_as_written(lambda *a: jbuild_model(jcfg).apply(
            {"params": params, "batch_stats": bstats}, *a, train=False), *args)[-1])
        m, _ = _port(cfg)
        m.eval()
        with torch.inference_mode():
            out = m(*map(_t, args))
        assert out[-1].dtype == torch.float32
        wavs["port", dtype] = out[-1].numpy()
    gap = lambda a, b: float(np.mean(np.abs(wavs[a] - wavs[b])))
    port_vs_jax = gap(("port", "bfloat16"), ("jax", "bfloat16"))
    bf16_vs_f32 = min(gap(("port", "bfloat16"), ("port", "float32")),
                      gap(("jax", "bfloat16"), ("jax", "float32")))
    assert np.isfinite(wavs["port", "bfloat16"]).all()
    assert port_vs_jax * SEPARATION <= bf16_vs_f32, (port_vs_jax, bf16_vs_f32)
    assert gap(("port", "bfloat16"), ("port", "float32")) < BF16_VS_F32_MEAN


def test_crn_bf16_eval_close_to_f32_and_trains():
    """Mirrors tests/test_model_variants.py::test_crn_bf16_compute_close_to_f32
    on the port: the bf16 eval step's output f32 and its loss within 5% of
    the f32 path's, and five bf16 train steps lower the loss."""
    rng = np.random.default_rng(7)
    L = 16000
    noisy = (rng.standard_normal((2, L)) * 0.1).astype(np.float32)
    clean = (rng.standard_normal((2, L)) * 0.1).astype(np.float32)
    losses = {}
    for dtype in ("float32", "bfloat16"):
        m, _ = _port(_cfgs("CRN", "real", dtype)[1])
        metrics, out = eval_step(_cfgs("CRN", "real", dtype)[1], m, noisy, clean)
        assert out.dtype == torch.float32
        losses[dtype] = metrics["loss"].item()
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"], rtol=0.05)

    _, cfg = _cfgs("CRN", "real")
    m, opt = _port(cfg)
    steps = [train_step(cfg, m, opt, noisy, clean)["loss"].item() for _ in range(5)]
    assert np.isfinite(steps).all() and steps[-1] < steps[0], steps


# DCCRN bf16 train step, port vs JAX (the same bf16 semantics).  The loss
# (measured 8e-7 relative).  The gradients: a bf16 backward rounds every
# cotangent, and the two frameworks reduce bf16 sums (a bias's gradient over
# B x F x T) at other precisions, so a leaf's bf16 gradient is as far from
# JAX's bf16 one as JAX's is from the f32 gradient (for several leaves, as
# far as the leaf's own size).  Each leaf is held within GRAD_BAND times the
# reference's own bf16-vs-f32 distance (measured at most 1.31x), plus
# GRAD_FLOOR of the leaf's max; the port's f32 gradient stands for the f32
# one (tests/test_torch_train.py holds it to JAX's within 1e-3 of each
# leaf's max).  A wrong gradient, off by far more than bf16 noise, fails.
BF16_LOSS_RTOL = 1e-5
GRAD_BAND, GRAD_FLOOR = 1.5, 1e-3


def test_dccrn_bf16_gradients_match_jax_and_train():
    """The SDR loss and every parameter's gradient of the bf16 DCCRN in
    train mode against the JAX package's (``jax.grad`` of its train step's
    loss, Pallas LSTMs) on the same weights and batch; then four bf16 train
    steps lower the loss, mirroring
    tests/test_train_step.py::test_dccrn_bf16_compute_trains."""
    jcfg, cfg = _cfgs("DCCRN")
    params, bstats = _tree(cfg)
    noisy, clean = _batch(1, 4000)
    jmodel = jbuild_model(jcfg)

    def loss_fn(p):
        return _loss_and_outputs(jcfg, jmodel, p, jax.tree.map(jnp.asarray, bstats),
                                 jnp.asarray(noisy), jnp.asarray(clean), train=True,
                                 dropout_rng=None)[0]

    want_loss, grads = _jit_as_written(jax.value_and_grad(loss_fn), params)
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.array, grads), bstats, cfg).items()}

    got = {}
    for c in (cfg, _cfgs("DCCRN", dtype="float32")[1]):
        model, _ = _port(c)
        model.train()
        loss = main_loss(c.loss, model(_t(noisy))[-1], _t(clean))
        loss.backward()
        got[c.compute_dtype] = {k: p.grad.numpy() for k, p in model.named_parameters()}
        if c is cfg:
            np.testing.assert_allclose(loss.item(), float(want_loss), rtol=BF16_LOSS_RTOL)
    for k, g in got["bfloat16"].items():
        err = np.abs(g - want[k]).max()
        band = np.abs(got["float32"][k] - want[k]).max()
        assert err <= GRAD_BAND * band + GRAD_FLOOR * np.abs(want[k]).max(), (k, err, band)

    model, opt = _port(cfg)
    losses = [train_step(cfg, model, opt, noisy, clean)["loss"].item() for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


# --- Adam with a bf16 first moment ---------------------------------------------


def test_adam_bf16_mu_matches_optax():
    """``TrainConfig(adam_mu_dtype="bfloat16")`` gives the port's own Adam,
    which follows ``optax.adam(mu_dtype=jnp.bfloat16)`` over 10 steps of
    seeded gradients within 1e-6 (its stored mu bit for bit in bf16), and,
    mirroring tests/test_train_parity.py::test_adam_bf16_mu_matches_f32_direction,
    stays within 3e-4 of the f32 Adam."""
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((32, 16)).astype(np.float32)
    grads = [rng.standard_normal((32, 16)).astype(np.float32) for _ in range(10)]
    cfg = Config(train=TrainConfig(learning_rate=1e-3, adam_mu_dtype="bfloat16"))
    out = {}
    for mu_dtype in (None, "bfloat16"):
        c = cfg.replace(train=TrainConfig(learning_rate=1e-3, adam_mu_dtype=mu_dtype))
        module = torch.nn.ParameterList([torch.nn.Parameter(_t(p0))])
        opt = make_optimizer(c, module)
        assert isinstance(opt, AdamLowPrecisionMu) == (mu_dtype is not None)
        for g in grads:
            module[0].grad = _t(g)
            opt.step()
        out[mu_dtype] = (module[0].detach().numpy(), opt)

    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8, mu_dtype=BF16)
    p = jnp.asarray(p0)
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, updates)
    got, opt = out["bfloat16"]
    np.testing.assert_allclose(got, np.asarray(p), atol=1e-6)
    mu = opt.state[opt.param_groups[0]["params"][0]]["mu"]
    assert mu.dtype == torch.bfloat16
    np.testing.assert_array_equal(mu.float().numpy(), np.asarray(state[0].mu, np.float32))
    np.testing.assert_allclose(got, out[None][0], atol=3e-4)


# --- the enhance CLI -----------------------------------------------------------


def test_enhance_cli_bf16_batch_matches_single_and_f32(tmp_path):
    """``python -m se_tpu_torch.enhance --compute-dtype bfloat16`` (run in
    process) on a full-width DCCRN with the reference's initialisation, as
    tests/test_cli.py::test_enhance_cli_batch_bf16_parity runs the JAX CLI:
    ``--batch 2`` against the single-file bf16 run within 2 int16 LSBs (rows
    are independent at any dtype), and against the f32 run within 32 LSBs."""
    cfg = Config()
    ckpt = save_reference_checkpoint(str(tmp_path / "c.pt"),
                                     build_model(cfg, device="cpu").state_dict())
    rng = np.random.default_rng(7)
    lengths = {"a.wav": 20000, "b.wav": 24000}
    for name, L in lengths.items():
        write_wav(str(tmp_path / name), rng.standard_normal(L) * 0.05, cfg.stft.fs)
    files = [str(tmp_path / n) for n in lengths]
    outs = {}
    for mode, flags in (("single_bf16", ["--compute-dtype", "bfloat16"]),
                        ("batch_bf16", ["--batch", "2", "--compute-dtype", "bfloat16"]),
                        ("single_f32", [])):
        enhance_main(["--checkpoint", ckpt, "--model", "DCCRN", "--device", "cpu", *flags,
                      *files, "--out-dir", str(tmp_path / mode)])
        outs[mode] = {n: read_wav(str(tmp_path / mode / n))[0] for n in lengths}
    for name, L in lengths.items():
        got = outs["batch_bf16"][name]
        assert len(got) == L
        np.testing.assert_allclose(got, outs["single_bf16"][name], atol=2 / 32768)
        np.testing.assert_allclose(got, outs["single_f32"][name], atol=32 / 32768)
        assert not np.array_equal(got, outs["single_f32"][name])


# --- what still refuses bf16 ---------------------------------------------------


def _wrapper_calls():
    """Each hand kernel's wrapper with one weight in bf16 (the rest valid)."""
    rng = np.random.default_rng(0)
    a = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    T, L, Bb, H, In = 3, 1, 2, 4, 5
    xp, x, st = a(T, L, Bb, 4 * H), a(T, L, Bb, In), a(L, Bb, H)
    w_hh, w_ih, b = a(L, H, 4 * H), a(L, In, 4 * H), a(L, 4 * H)
    bad = lambda t: t.bfloat16()
    ys, cs = a(T, L, Bb, H), a(T, L, Bb, H)
    return {
        "K1f": lambda: fused_lstm.fused_lstm_scan(xp, bad(w_hh), st, st),
        "K1b": lambda: fused_lstm.fused_lstm_scan_backward(xp, bad(w_hh), st, st, ys, cs, ys,
                                                          st, st),
        "K2f": lambda: fused_lstm_inproj.fused_lstm_scan_inproj(x, bad(w_ih), b, w_hh, st, st),
        "K2b": lambda: fused_lstm_inproj.fused_lstm_scan_inproj_backward(
            x, w_ih, bad(b), w_hh, st, st, ys, cs, ys, st, st),
        "K3f": lambda: fused_gru_inproj.fused_gru_scan_inproj(
            x, a(L, In, 3 * H), a(L, 3 * H), bad(a(L, H, 3 * H)), a(L, 3 * H), st),
        "K4": lambda: fused_conv.fused_complex_conv2d(a(2, 1, 8, 6), bad(a(4, 1, 5, 2)), a(4)),
    }


@pytest.mark.parametrize("kernel", ["K1f", "K1b", "K2f", "K2b", "K3f", "K4"])
def test_wrappers_refuse_a_bf16_weight(kernel):
    """Weights, carries and the stash are f32 in every form: a bf16 weight
    raises, whatever the stream's dtype."""
    with pytest.raises(TypeError, match="float32"):
        _wrapper_calls()[kernel]()


def test_bf16_paths_not_ported_raise():
    """The bf16 stream of one LSTM scan must match its ys and dys.  (The
    bf16 paths this test once saw refused, the fused encoder conv, ``gru``
    and FullSubNet, are ported: tests/test_torch_fullsubnet_bf16.py.)"""
    inputs, _ = _case(2, 3, 1, 2, 4)
    xp = _t(inputs[0]).bfloat16()
    w_hh, h0, c0 = map(_t, inputs[1:])
    ys = torch.zeros(3, 1, 2, 4)  # f32 where the bf16 form wants bf16
    with pytest.raises(TypeError, match="ys must be torch.bfloat16"):
        fused_lstm.fused_lstm_scan_backward(xp, w_hh, h0, c0, ys, ys, ys.bfloat16(), h0, c0)
