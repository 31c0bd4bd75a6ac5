"""The PyTorch port's bf16 FullSubNet and fused-conv DCCRN (se_tpu_torch,
``compute_dtype="bfloat16"``) against the JAX package on the CPU at a tiny
width: the bf16-stream form of the in-projection GRU scan K3 (plain
versions) against the Pallas kernels run in interpret mode, ``rnn.gru``
against both of the reference's bf16 forms, K4's bf16 form (plain version
and its gradients) against the Pallas conv in interpret mode, FullSubNet
(LSTM and GRU) under bf16 (forward, gradients, eval loss, training), the
tiny DCCRN with ``use_pallas_conv=True`` under bf16 (forward and
gradients), and the FullSubNet enhance CLI with ``--compute-dtype
bfloat16``.

The JAX side runs its Pallas kernels (``use_pallas_lstm="on"``, the form
``"auto"`` takes on a TPU; the Pallas conv in interpret mode) and is
compiled with every bf16 value rounded as written (``_jit_as_written``);
its weights are numpy trees (``random_fullsubnet_params``,
``random_dccrn_params``).  Inputs come from numpy seeds and go through both
packages, cast to bf16 by each (both round to nearest even, so the bf16
inputs are the same bits)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import se_tpu.ops.norms as jnorms
import se_tpu.ops.pallas_conv as PC
from se_tpu.config import (
    Config as JConfig,
    DccrnConfig as JDccrnConfig,
    FullSubNetConfig as JFullSubNetConfig,
    StftConfig as JStftConfig,
)
from se_tpu.models import build_model as jbuild_model
from se_tpu.ops import rnn as jrnn
from se_tpu.train.steps import _loss_and_outputs as jloss_and_outputs

from se_tpu_torch import enhance as tenhance
from se_tpu_torch.config import Config, DccrnConfig, FullSubNetConfig, StftConfig
from se_tpu_torch.data.wav import read_wav, write_wav
from se_tpu_torch.ops import fused_conv, fused_gru_inproj
from se_tpu_torch.ops import rnn as trnn
from se_tpu_torch.train.state import create_train_state
from se_tpu_torch.train.steps import _loss_and_outputs, eval_step, train_step
from se_tpu_torch.utils.weights import (
    random_dccrn_params,
    random_fullsubnet_params,
    save_reference_checkpoint,
    state_dict_from_jax,
)

BF16 = jnp.bfloat16
TINY_STFT = dict(fft_len=64, win_len=48)  # torch_hop 36, 33 bins
TINY_FSN = dict(fb_model_hidden_size=32, sb_model_hidden_size=24, sb_num_neighbors=3)
# two encoder stages and one complex LSTM layer: every kind of layer of the
# fused path, at the least tracing time for the interpreted Pallas kernels
TINY_DCCRN = dict(kernel_num=(8, 16), rnn_units=32, rnn_layers=1)
# f32 outputs of the bf16 forms (hT and the weight, bias and state
# gradients): the same f32 arithmetic as the JAX kernel, summed in another
# order, as the f32 forms' tests hold them (tests/test_torch_fullsubnet.py)
F32_ATOL, F32_RTOL = 1e-5, 1e-4
# bf16 outputs (ys, dx, y): a sum taken in another order can tip a
# rounding, so each element within one bf16 ulp of its magnitude
BF16_ULPS = 1.0
# port bf16 vs JAX bf16 (cRM or waveform): at least this many times nearer,
# by mean |difference|, than the port's bf16 output is to its f32 output
# (tests/test_torch_bf16.py)
SEPARATION = 4
# the eval loss under bf16 against f32, the JAX package's own gate
# (tests/test_model_variants.py:192)
EVAL_LOSS_RTOL = 0.05
# the loss of a bf16 step, port vs JAX (the same bf16 semantics), relative
# to max(1, |loss|) as chip_smoke.py holds a loss: the fused-conv DCCRN's
# SDR loss at this size is near 2 in train mode, and tipped roundings moved
# it by 3e-6 to 6e-5 relative over four batches
BF16_LOSS_RTOL = 1e-4
# A bf16 gradient leaf, port vs JAX: a bf16 backward rounds every cotangent
# and the frameworks sum bf16 reductions at other precisions, so each leaf
# is held within a band of GRAD_BAND times the reference's own bf16-vs-f32
# distance (the port's f32 gradient stands for the f32 one: the f32 tests
# hold it to JAX's within 1e-3 of each leaf's max), plus GRAD_FLOOR of the
# leaf's max (tests/test_torch_bf16.py), by model.  Measured, as (err -
# floor) / distance: FullSubNet at most 1.00 (LSTM and GRU); the fused-conv
# DCCRN at most 1.24 in train mode over four batches, held at the unfused
# bf16 DCCRN's band (tests/test_torch_bf16.py, measured there 1.31).
GRAD_BAND = {"FullSubNet": 1.2, "DCCRN": 1.5}
GRAD_FLOOR = 1e-3


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


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """The JAX package's fused_complex_conv2d looks _pallas_conv up by name."""
    monkeypatch.setattr(PC, "_pallas_conv", functools.partial(PC._pallas_conv, interpret=True))


def _ulps(got, want) -> float:
    """max over elements of |got - want| in bf16 ulps of max(|got|, |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.ldexp(np.float32(1.0), np.frexp(mag)[1] - 8)  # 2^(e-8): [2^-8, 2^-7] of mag
    return float(np.max(np.abs(got - want) / np.maximum(ulp, np.finfo(np.float32).tiny)))


def _bf16_err(got, exact) -> float:
    """max over elements of |got - exact| over one bf16 ulp of max(|got|,
    |exact|) plus F32_RTOL of the largest |exact| (a sum of both signs
    that cancels near 0 carries the f32 error of its terms)."""
    mag = np.maximum(np.abs(got), np.abs(exact))
    ulp = np.ldexp(1.0, np.frexp(mag)[1] - 8)
    return float(np.max(np.abs(got - exact) / (ulp + F32_RTOL * np.abs(exact).max())))


def _compile_as_written(fn, *args):
    """``fn`` compiled for ``args`` with every bf16 value rounded as
    written: by default XLA on the CPU keeps a chain of bf16 operations in
    f32 (``xla_allow_excess_precision``; tests/test_torch_bf16.py)."""
    return jax.jit(fn).lower(*jax.tree.map(jnp.asarray, args)).compile(
        compiler_options={"xla_allow_excess_precision": False,
                          "xla_backend_optimization_level": 0})


def _jit_as_written(fn, *args):
    args = jax.tree.map(jnp.asarray, args)
    return _compile_as_written(fn, *args)(*args)


# --- K3 (the in-projection GRU scan's bf16-stream form) and rnn.gru -------------


# rnn.gru (K3's form) against the reference's scan form, which rounds the
# projection to bf16 where K3 projects the upcast x in f32 (ROADMAP.md,
# Queue 3).  Measured on this case: 46% of ys apart, max |diff| 3.9e-3,
# mean 5.5e-4, against 0 ulps from the Pallas form.  Held at twice that.
SCAN_FORM_MAX, SCAN_FORM_MEAN = 8e-3, 1.1e-3


def test_k3_bf16_and_rnn_gru_match_pallas():
    """``rnn.gru`` on a bf16 input (K3's bf16-stream form: on the CPU its
    plain versions) against JAX ``rnn.gru`` in both its bf16 forms.  The
    Pallas form (``use_pallas=True``, K3 in interpret mode): ys bf16 within
    one bf16 ulp; hT f32 and the gradients of the four weights and of h0 at
    the f32 form's tolerance; dx bf16 within one bf16 ulp.  K3's plain
    backward, fed the Pallas forward's own ys and the same bf16 dys (fed its
    own forward's ys, a backward inherits every rounding that an f32 sum in
    another order tipped): the same six gradients at the same tolerances.
    The scan form (``use_pallas=False``): the gap that Queue 3 records.
    Through autograd the gradients keep their inputs' dtypes, and no launch
    count moves on the CPU."""
    rng = np.random.default_rng(4)
    T, B, In, H = 8, 3, 10, 12  # B not a multiple of 8: the Pallas kernel pads
    k = 1 / np.sqrt(H)
    w = [rng.uniform(-k, k, s).astype(np.float32)
         for s in ((3 * H, In), (3 * H, H), (3 * H,), (3 * H,))]
    x = rng.standard_normal((T, B, In)).astype(np.float32)
    h0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    dys = rng.standard_normal((T, B, H)).astype(np.float32)

    def jloss(params, state, xx, pallas):
        ys, hT = jrnn.gru(jrnn.LstmParams(*params), xx.astype(BF16), state, use_pallas=pallas)
        return jnp.sum(ys.astype(jnp.float32) * dys) + jnp.sum(hT), (ys, hT)

    (_, (ys_p, hT_p)), (dw_p, dh0_p, dx_p) = _jit_as_written(jax.value_and_grad(
        functools.partial(jloss, pallas=True), argnums=(0, 1, 2), has_aux=True), w, h0, x)
    _, (ys_s, _) = _jit_as_written(functools.partial(jloss, pallas=False), w, h0, x)
    assert ys_p.dtype == BF16

    counts = [(f.launches, f.launches_bf16) for f in (
        fused_gru_inproj.fused_gru_scan_inproj, fused_gru_inproj.fused_gru_scan_inproj_backward)]
    params = [_t(a).requires_grad_() for a in w]
    state = _t(h0).requires_grad_()
    xb = _t(x).bfloat16().requires_grad_()
    ys, hT = trnn.gru(trnn.LstmParams(*params), xb, state)
    assert ys.dtype == torch.bfloat16 and hT.dtype == torch.float32
    grads = torch.autograd.grad((ys.float() * _t(dys)).sum() + hT.sum(), [*params, state, xb])
    assert [g.dtype for g in grads] == [a.dtype for a in (*params, state, xb)]
    assert _ulps(ys.detach().float(), ys_p) <= BF16_ULPS
    assert _ulps(grads[-1].float(), dx_p) <= BF16_ULPS
    for got, want in zip((hT, *grads[:-1]), (hT_p, *dw_p, dh0_p)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=F32_ATOL, rtol=F32_RTOL)

    # K3's plain backward on the Pallas forward's ys; the weights as rnn.gru
    # hands them over (transposed, a stack axis of 1)
    stack = lambda a: _t(a)[None].contiguous()
    got = fused_gru_inproj.fused_gru_scan_inproj_backward(
        _t(x).bfloat16()[:, None], stack(w[0].T), stack(w[2]), stack(w[1].T), stack(w[3]),
        stack(h0), _t(np.asarray(ys_p, np.float32)).bfloat16()[:, None],
        _t(dys).bfloat16()[:, None], torch.ones(1, B, H))
    want = (dx_p, dw_p[0].T, dw_p[2], dw_p[1].T, dw_p[3], dh0_p)
    assert got[0].dtype == torch.bfloat16
    assert _ulps(got[0][:, 0].float(), want[0]) <= BF16_ULPS
    for g, want_g in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g[0].numpy(), np.asarray(want_g), atol=F32_ATOL, rtol=F32_RTOL)
    assert counts == [(f.launches, f.launches_bf16) for f in (
        fused_gru_inproj.fused_gru_scan_inproj, fused_gru_inproj.fused_gru_scan_inproj_backward)]

    gap = np.abs(ys.detach().float().numpy() - np.asarray(ys_s, np.float32))
    assert 0 < gap.mean() <= SCAN_FORM_MEAN and gap.max() <= SCAN_FORM_MAX, (gap.mean(), gap.max())


# --- K4: the fused encoder conv's bf16 form ---------------------------------------


def test_k4_bf16_plain_version_and_gradients_match_pallas_conv():
    """K4's bf16 form on the CPU (the plain version: f32 conv of the bf16
    values, rounded once) against ``_pallas_conv`` in interpret mode on the
    same bf16 x with the f32 w and b, which both cast to bf16: within one
    bf16 ulp.  Then the conv gradients through the port's Function against
    ``jax.vjp`` of ``fused_complex_conv2d`` (the vjp of the reference's bf16
    XLA conv) for a bf16 cotangent: dx in bf16, dw and db f32 of bf16
    values.  Both are held to the exact gradient (f64, on the same bf16
    operands), not to each other: on the CPU, XLA sums db and dw, and
    torch's bf16 convolution backward dw, with bf16 partial sums (measured
    against the exact values: JAX db up to 174 bf16 ulps, dw 59; the port
    db 0.5, dw 27, dx 1.75 both), where the TPU's and cuDNN's products sum
    in f32.  So each of the port's gradients must be within one bf16 ulp
    (plus the f32 tolerance) of the exact one, or no farther from it than
    the reference's (ROADMAP.md, Queue 3)."""
    B2, C, Fq, T, Co = 4, 16, 32, 33, 32  # DCCRN's second stage, narrower, T odd
    rng = np.random.default_rng(B2 * C + T)
    x = rng.standard_normal((B2, C, Fq, T)).astype(np.float32)
    w = (rng.standard_normal((Co, C, 5, 2)) * 0.05).astype(np.float32)
    b = rng.standard_normal(Co).astype(np.float32)
    g = rng.standard_normal((B2, Co, Fq // 2, T)).astype(np.float32)

    def jfn(x, w, b, g):
        y, vjp = jax.vjp(PC.fused_complex_conv2d, x.astype(BF16), w, b)
        return y, vjp(g.astype(BF16))

    y_j, grads_j = _jit_as_written(jfn, x, w, b, g)
    assert y_j.dtype == grads_j[0].dtype == BF16

    args = [_t(x).bfloat16().requires_grad_(), _t(w).requires_grad_(), _t(b).requires_grad_()]
    y = fused_conv.fused_complex_conv2d(*args)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == y_j.shape
    assert _ulps(y.detach().float(), y_j) <= BF16_ULPS
    grads = torch.autograd.grad(y, args, _t(g).bfloat16())
    assert [gr.dtype for gr in grads] == [torch.bfloat16, torch.float32, torch.float32]
    xb, wb, bb = (t.detach().bfloat16().double().requires_grad_() for t in args)
    exact = torch.autograd.grad(fused_conv.reference(xb, wb, bb), (xb, wb, bb),
                                _t(g).bfloat16().double())
    for got, want, ex in zip(grads, grads_j, exact):
        port_err = _bf16_err(got.float().numpy(), ex.numpy())
        assert port_err <= max(1.0, _bf16_err(np.asarray(want, np.float32), ex.numpy())), port_err


# --- FullSubNet under bf16 ------------------------------------------------------------


def _fsn_cfgs(seq, dtype="bfloat16", dropout=0.0):
    fsn = {**TINY_FSN, "dropout": dropout}
    common = dict(model="FullSubNet", loss="MSE", sequence_model=seq, compute_dtype=dtype)
    return (
        JConfig(**common, stft=JStftConfig(**TINY_STFT), fullsubnet=JFullSubNetConfig(**fsn),
                use_pallas_lstm="on"),
        Config(**common, stft=StftConfig(**TINY_STFT), fullsubnet=FullSubNetConfig(**fsn)),
    )


@functools.lru_cache(maxsize=None)
def _fsn_tree(seq):
    return random_fullsubnet_params(_fsn_cfgs(seq)[1], seed=0)


def _batch(seed, n):
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((2, n)) * 0.1).astype(np.float32)
    return (clean + rng.standard_normal((2, n)) * 0.05).astype(np.float32), clean


def _port_grads(cfg, sd, noisy, clean, train):
    """The port's loss, outputs and gradients by parameter name, in train or
    eval mode."""
    model, _ = create_train_state(cfg, sd, device="cpu")
    model.train(train)
    variant = "fullsubnet" if cfg.model == "FullSubNet" else "masking"
    loss, _, outputs = _loss_and_outputs(cfg, variant, model, _t(noisy), _t(clean))
    loss.backward()
    out = outputs[0] if variant == "fullsubnet" else outputs
    return loss.item(), out.detach().float().numpy(), {
        k: p.grad.numpy() for k, p in model.named_parameters()}


@jax.custom_vjp
def _divide(x, d, f32_sum):
    return x / d


def _divide_fwd(x, d, f32_sum):
    return x / d, (x, d, f32_sum)


def _divide_bwd(res, g):
    """x / d's gradient as autodiff writes it (the vjp of the same
    expression: d's, the transpose of its broadcast over C x F x T, summed
    in bf16 by XLA on the CPU), or, where ``f32_sum``, d's summed in f32 as
    torch sums a bf16 reduction."""
    x, d, f32_sum = res
    dx, dd = jax.vjp(jnp.divide, x, d)[1](g)
    dd32 = jnp.sum((-g * x / (d * d)).astype(jnp.float32), axis=(1, 2, 3), keepdims=True)
    return dx, jnp.where(f32_sum, dd32.astype(d.dtype), dd), jnp.zeros_like(f32_sum)


_divide.defvjp(_divide_fwd, _divide_bwd)


def _offline_laplace_norm(x, valid_frames=None, *, f32_sum):
    """``se_tpu.ops.norms.offline_laplace_norm``: the same forward; its
    statistic's gradient summed in f32 where the traced ``f32_sum``."""
    assert valid_frames is None
    mu = jnp.mean(x, axis=(1, 2, 3), keepdims=True, dtype=jnp.float32)
    return _divide(x, (mu + 1e-5).astype(x.dtype), f32_sum)


def _jax_steps(jcfg, cfg, params, bstats, noisy, clean, train, f32_sums=(False,)):
    """The JAX package's loss, output (its cRM or waveform) and gradients by
    the port's parameter names (``jax.value_and_grad`` of its step's loss,
    Pallas kernels), in train or eval mode, once for each of ``f32_sums``:
    False is the package as written, True the same but the offline norm's
    statistic gradient summed in f32 (``_offline_laplace_norm``).  One
    compiled program, the switch its argument; switched off, it gave the
    package's own program's loss, output and gradients bit for bit
    (measured on both FullSubNet cases)."""
    jmodel = jbuild_model(jcfg)
    fullsubnet = cfg.model == "FullSubNet"

    def loss_fn(p, f32_sum):
        with pytest.MonkeyPatch.context() as m:  # norm_wrapper looks the norm up here
            m.setattr(jnorms, "offline_laplace_norm",
                      functools.partial(_offline_laplace_norm, f32_sum=f32_sum))
            loss, (_, outputs, _) = jloss_and_outputs(
                jcfg, jmodel, p, jax.tree.map(jnp.asarray, bstats), jnp.asarray(noisy),
                jnp.asarray(clean), train=train, dropout_rng=None)
        return loss, outputs[0] if fullsubnet else outputs

    params = jax.tree.map(jnp.asarray, params)
    step = _compile_as_written(jax.value_and_grad(loss_fn, has_aux=True), params, False)
    out = []
    for f32_sum in f32_sums:
        (loss, y), grads = step(params, jnp.asarray(f32_sum))
        out.append((float(loss), np.asarray(y, np.float32), {
            k: v.numpy() for k, v in state_dict_from_jax(
                jax.tree.map(np.array, grads), bstats, cfg).items()}))
    return out


def _check_against_jax(jcfg, cfg, params, bstats, noisy, clean, train, f32_sums=(False,)):
    """The port's bf16 forward (its cRM or waveform), loss and gradients, in
    train or eval mode, against the JAX package's as written on the same
    weights and batch: the output SEPARATION times nearer JAX's than the
    port's f32 output, the loss at BF16_LOSS_RTOL, each gradient leaf within
    its model's band.  Returns the port's bf16 and f32 gradients and JAX's
    steps (``_jax_steps``)."""
    steps = _jax_steps(jcfg, cfg, params, bstats, noisy, clean, train, f32_sums)
    want_loss, want_out, want = steps[0]
    sd = state_dict_from_jax(params, bstats, cfg)
    loss, out, got = _port_grads(cfg, sd, noisy, clean, train)
    _, out32, got32 = _port_grads(cfg.replace(compute_dtype="float32"), sd, noisy, clean, train)

    assert abs(loss - want_loss) <= BF16_LOSS_RTOL * max(1.0, abs(want_loss)), (loss, want_loss)
    port_vs_jax = float(np.mean(np.abs(out - want_out)))
    bf16_vs_f32 = float(np.mean(np.abs(out - out32)))
    assert np.isfinite(out).all()
    assert port_vs_jax * SEPARATION <= bf16_vs_f32, (port_vs_jax, bf16_vs_f32)
    for k, g in got.items():
        err = np.abs(g - want[k]).max()
        band = np.abs(got32[k] - want[k]).max()
        limit = GRAD_BAND[cfg.model] * band + GRAD_FLOOR * np.abs(want[k]).max()
        assert err <= limit, (k, err, band)
    return got, got32, steps


@pytest.mark.parametrize("seq", ["LSTM", "GRU"])
def test_fullsubnet_bf16_forward_and_gradients_match_jax(seq):
    """FullSubNet under bf16 at dropout 0, port vs JAX (Pallas LSTM or GRU
    kernels, their bf16-stream forms): the cRM of the train-mode forward
    (with dropout 0 the same as the eval forward: FullSubNet holds no
    BatchNorm), the MSE loss and every parameter's gradient, as
    ``_check_against_jax`` states.

    The band alone cannot tell a bf16 backward from an f32 one (that would
    read 1.0), and on several leaves the reference's bf16 noise fills it:
    XLA on the CPU sums the offline norm's statistic gradient (over C x F x
    T) and a Linear bias's gradient (over B x F x T rows) in bf16.  The
    first reaches every full-band leaf: measured with the LSTM, JAX's bf16
    gradient there is 13-17% of each leaf's max from its f32 one, the
    port's 0.1-0.4%.  So the reference is taken once more with only that
    sum in f32 (``_offline_laplace_norm``), and every leaf but the two
    output layers' biases must be SEPARATION times nearer it than the
    port's f32 gradient is (measured: at most 0.0025 of the distance with
    the LSTM, 0.012 with the GRU; as written, 1.00 on the LSTM's full
    band)."""
    jcfg, cfg = _fsn_cfgs(seq)
    noisy, clean = _batch(1, 2000)
    params, bstats = _fsn_tree(seq)
    got, got32, steps = _check_against_jax(jcfg, cfg, params, bstats, noisy, clean, train=True,
                                           f32_sums=(False, True))
    _, _, want = steps[1]
    for k, g in got.items():
        if k.endswith("fc_output_layer.bias"):
            continue
        err, dist = np.abs(g - want[k]).max(), np.abs(got32[k] - want[k]).max()
        assert err * SEPARATION <= dist, (k, err, dist)


@pytest.mark.parametrize("seq", ["LSTM", "GRU"])
def test_fullsubnet_bf16_eval_close_to_f32_and_trains(seq):
    """Mirrors tests/test_model_variants.py::test_fullsubnet_bf16_compute_close_to_f32
    and ::test_fullsubnet_gru_bf16_trains on the port: the bf16 eval step's
    output f32 and its loss within 5% of the f32 path's; five bf16 train
    steps with the default dropout of 0.8 (the model's own generator) give
    finite losses and lower the batch's dropout-free loss."""
    rng = np.random.default_rng(11)
    noisy = (rng.standard_normal((2, 2000)) * 0.1).astype(np.float32)
    clean = (rng.standard_normal((2, 2000)) * 0.1).astype(np.float32)
    sd = state_dict_from_jax(*_fsn_tree(seq), _fsn_cfgs(seq)[1])
    losses = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _fsn_cfgs(seq, dtype)[1]
        model, _ = create_train_state(cfg, sd, device="cpu")
        metrics, out = eval_step(cfg, model, noisy, clean)
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
        losses[dtype] = metrics["loss"].item()
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"], rtol=EVAL_LOSS_RTOL)

    cfg = _fsn_cfgs(seq, dropout=0.8)[1]
    model, opt = create_train_state(cfg, sd, device="cpu")
    before = eval_step(cfg, model, noisy, clean)[0]["loss"].item()
    steps = [train_step(cfg, model, opt, noisy, clean)["loss"].item() for _ in range(5)]
    after = eval_step(cfg, model, noisy, clean)[0]["loss"].item()
    assert np.isfinite(steps).all() and after < before, (steps, before, after)


# --- the tiny DCCRN with use_pallas_conv=True under bf16 --------------------------


def test_dccrn_fused_conv_bf16_forward_and_gradients_match_jax():
    """The tiny DCCRN with ``use_pallas_conv=True`` under bf16 (its encoder
    convs on K4's bf16 form, its complex LSTM on K1's), port vs JAX (its
    Pallas conv and LSTM kernels), in train mode (the BatchNorms on batch
    statistics, the path a train step takes): the waveform, the SDR loss and
    every parameter's gradient, as ``_check_against_jax`` states.  Measured
    over four batches: the loss 3e-6 to 6e-5 apart (relative), the waveform
    4.5-16 times nearer JAX's than the f32 one, the gradients at most 1.24
    of the band; the unfused bf16 DCCRN at the same width on the same
    batches, 2e-5 to 7e-5, 5.8-12 times and 1.10."""
    common = dict(use_pallas_conv=True, compute_dtype="bfloat16")
    jcfg = JConfig(dccrn=JDccrnConfig(**TINY_DCCRN), use_pallas_lstm="on", **common)
    cfg = Config(dccrn=DccrnConfig(**TINY_DCCRN), **common)
    model, _ = create_train_state(cfg, None, device="cpu")
    assert all(stage[0].fused for stage in model.encoder)
    noisy, clean = _batch(2, 2000)
    _check_against_jax(jcfg, cfg, *random_dccrn_params(cfg, seed=0), noisy, clean, train=True)


# --- the enhance CLI -----------------------------------------------------------------


def test_enhance_cli_fullsubnet_bf16_batch_matches_single(tmp_path, monkeypatch):
    """``--model FullSubNet --sequence-model GRU --compute-dtype bfloat16``
    (run in process, at the tiny width, with the offline norm's bucketing):
    ``--batch 2`` against one file at a time within 2 int16 LSBs (rows are
    independent), and against the f32 run within 64 LSBs but not equal."""
    monkeypatch.setattr(tenhance, "Config", functools.partial(Config, stft=StftConfig(**TINY_STFT)))
    monkeypatch.setattr(tenhance, "FullSubNetConfig",
                        functools.partial(FullSubNetConfig, **TINY_FSN))
    cfg = _fsn_cfgs("GRU")[1]
    ckpt = save_reference_checkpoint(str(tmp_path / "fsn.pt"),
                                     state_dict_from_jax(*_fsn_tree("GRU"), cfg))
    rng = np.random.default_rng(12)
    lengths = {"a.wav": 5000, "b.wav": 7100}
    for name, L in lengths.items():
        write_wav(str(tmp_path / name), rng.standard_normal(L) * 0.1, cfg.stft.fs)
    files = [str(tmp_path / n) for n in lengths]
    outs = {}
    for mode, flags in (("single_bf16", ["--compute-dtype", "bfloat16"]),
                        ("batch_bf16", ["--batch", "2", "--compute-dtype", "bfloat16"]),
                        ("single_f32", [])):
        tenhance.main(["--checkpoint", ckpt, "--model", "FullSubNet", "--sequence-model", "GRU",
                       "--device", "cpu", *flags, *files, "--out-dir", str(tmp_path / mode)])
        outs[mode] = {n: read_wav(str(tmp_path / mode / n))[0] for n in lengths}
    for name, L in lengths.items():
        got = outs["batch_bf16"][name]
        assert len(got) == L
        np.testing.assert_allclose(got, outs["single_bf16"][name], atol=2 / 32768)
        np.testing.assert_allclose(got, outs["single_f32"][name], atol=64 / 32768)
        assert not np.array_equal(got, outs["single_f32"][name])
