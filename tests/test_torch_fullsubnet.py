"""The PyTorch port's FullSubNet slice (se_tpu_torch) against the JAX
package on the CPU at a tiny width: the in-projection GRU scan (K3)
forward and backward, ``rnn.gru``, the framework STFT, the cIRM, the
unfold, the four norms, the weight carry-over, the FullSubNet forward (LSTM
and GRU), its eval and train steps, dropout, and the enhance CLI with its
offline-norm bucketing.

The JAX side runs K3 in interpret mode at kernel level and the plain scan
(``use_pallas_lstm="off"``) at model level; ``tests/test_pallas_gru.py``
holds the two equal.  Inputs come from numpy seeds and go through both
packages; the JAX weights are numpy trees (``random_fullsubnet_params``)
handed to flax's ``apply`` directly, their layout checked against flax's
``init``."""

import functools
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from se_tpu.config import (
    Config as JConfig,
    FullSubNetConfig as JFullSubNetConfig,
    StftConfig as JStftConfig,
    TrainConfig as JTrainConfig,
)
from se_tpu.dsp import frame_istft, frame_stft
from se_tpu.models import build_model as jbuild_model
from se_tpu.ops import cirm as jcirm
from se_tpu.ops import norms as jnorms
from se_tpu.ops import pallas_lstm
from se_tpu.ops import rnn as jrnn
from se_tpu.ops.unfold import unfold as junfold
from se_tpu.train.state import TrainState, make_optimizer as jmake_optimizer
from se_tpu.train.steps import _loss_and_outputs, make_eval_step, make_train_step
from se_tpu.utils.torch_export import export_reference_state_dict

from se_tpu_torch import enhance as tenhance
from se_tpu_torch.config import Config, FullSubNetConfig, StftConfig, TrainConfig
from se_tpu_torch.data.wav import read_wav, write_wav
from se_tpu_torch.dsp.stft import istft, mag_phase, stft
from se_tpu_torch.enhance import enhance_batch
from se_tpu_torch.models import build_model
from se_tpu_torch.models.layers import TorchGRU, TorchLSTM, dropout
from se_tpu_torch.ops import cirm, norms, unfold
from se_tpu_torch.ops import rnn as trnn
from se_tpu_torch.ops.fused_gru_inproj import (
    fused_gru_scan_inproj,
    fused_gru_scan_inproj_backward,
    fused_gru_scan_inproj_backward_reference,
    fused_gru_scan_inproj_reference,
)
from se_tpu_torch.train.state import create_train_state
from se_tpu_torch.train.steps import eval_step, train_step
from se_tpu_torch.utils.weights import (
    random_fullsubnet_params,
    save_reference_checkpoint,
    state_dict_from_jax,
)

TINY_STFT = dict(fft_len=64, win_len=48)  # torch_hop 36, 33 bins
TINY_FSN = dict(fb_model_hidden_size=32, sb_model_hidden_size=24, sb_num_neighbors=3)
LR = 1e-3
GRAD_NAMES = ("dx", "dw_ih_t", "db_ih", "dw_hh_t", "db_hh", "dh0")


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


# --- K3: the in-projection GRU scan -------------------------------------------


def _gru_case(T, L, Bb, In, H, seed=0):
    """Forward inputs (torch's init range, nonzero h0) and seeded cotangents
    of (ys, hT)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    k = 1 / np.sqrt(H)
    return (
        rng.standard_normal((T, L, Bb, In)).astype(f),
        rng.uniform(-k, k, (L, In, 3 * H)).astype(f),
        rng.uniform(-k, k, (L, 3 * H)).astype(f),
        rng.uniform(-k, k, (L, H, 3 * H)).astype(f),
        rng.uniform(-k, k, (L, 3 * H)).astype(f),
        (rng.standard_normal((L, Bb, H)) * 0.5).astype(f),
    ), (
        rng.standard_normal((T, L, Bb, H)).astype(f),
        rng.standard_normal((L, Bb, H)).astype(f),
    )


def _torch_vjp(fn, inputs, cots):
    """``fn``'s outputs and the gradients of its six inputs for ``cots``."""
    args = [_t(a).requires_grad_() for a in inputs]
    ys, hT = fn(*args)
    total = (ys * _t(cots[0])).sum() + (hT * _t(cots[1])).sum()
    return (ys, hT), torch.autograd.grad(total, args)


@pytest.mark.parametrize("shape", [(10, 1, 12, 8, 16), (9, 2, 5, 7, 16)], ids=["L1", "L2-ragged"])
def test_gru_scan_matches_pallas_vjp(shape):
    """The port's Function (plain forward, plain backward) on the CPU
    against ``jax.vjp`` of the Pallas kernel run in interpret mode: ys, hT
    and the six input gradients at atol 1e-5, rtol 1e-4 (the same f32
    arithmetic summed in another order; the dW sums run over T x Bb rows).
    The ragged case has Bb = 5 and an odd In; h0 is nonzero."""
    inputs, cots = _gru_case(*shape)
    (ys_j, hT_j), vjp = jax.vjp(pallas_lstm.fused_gru_scan_inproj, *map(jnp.asarray, inputs))
    want = vjp(tuple(map(jnp.asarray, cots)))
    outs, got = _torch_vjp(fused_gru_scan_inproj, inputs, cots)
    for name, g, w in zip(("ys", "hT"), outs, (ys_j, hT_j)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    for name, g, w in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("cotangents", ["all", "ys-only"])
def test_gru_plain_backward_matches_autograd_of_plain_forward(cotangents):
    """The plain backward against torch's autograd of the plain recurrence,
    atol 1e-5; with ``dhT`` given as None when only ``ys`` is used, as the
    sequence models use it.  db_hh's n slice (inside the product with r)
    differs from db_ih's, and dW_hh's with it."""
    inputs, cots = _gru_case(6, 2, 3, 7, 8, seed=1)
    if cotangents == "ys-only":
        cots = (cots[0], np.zeros_like(cots[1]))
    _, want = _torch_vjp(fused_gru_scan_inproj_reference, inputs, cots)
    args = list(map(_t, inputs))
    ys, _ = fused_gru_scan_inproj_reference(*args)
    tail = (_t(cots[0]), None) if cotangents == "ys-only" else map(_t, cots)
    got = fused_gru_scan_inproj_backward(*args, ys, *tail)
    for name, g, w in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, err_msg=name)
    H = inputs[5].shape[-1]
    assert not torch.allclose(got[4][:, 2 * H:], got[2][:, 2 * H:])
    assert torch.equal(got[4][:, : 2 * H], got[2][:, : 2 * H])


def test_gru_wrapper_on_cpu_runs_plain_without_counting():
    """CPU tensors take the plain versions and count no launch; with an input
    that needs a gradient the call goes through the Function, which saves
    only ``ys`` beside its inputs; bad inputs raise."""
    inputs, cots = _gru_case(5, 1, 3, 6, 8, seed=2)
    args = list(map(_t, inputs))
    before = fused_gru_scan_inproj.launches, fused_gru_scan_inproj_backward.launches
    ys, hT = fused_gru_scan_inproj(*args)
    ys_r, hT_r = fused_gru_scan_inproj_reference(*args)
    assert torch.equal(ys, ys_r) and torch.equal(hT, hT_r)
    got = fused_gru_scan_inproj_backward(*args, ys, *map(_t, cots))
    want = fused_gru_scan_inproj_backward_reference(*args, ys, *map(_t, cots))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ys_g, _ = fused_gru_scan_inproj(*[a.clone().requires_grad_() for a in args])
    saved = ys_g.grad_fn.saved_tensors
    assert len(saved) == 7 and torch.equal(saved[-1], ys)
    assert (fused_gru_scan_inproj.launches,
            fused_gru_scan_inproj_backward.launches) == before

    with pytest.raises(TypeError):
        fused_gru_scan_inproj(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        fused_gru_scan_inproj(args[0][:, :, :, :-1], *args[1:])
    with pytest.raises(ValueError):  # b_hh of 4H, an LSTM's
        fused_gru_scan_inproj(*args[:4], torch.zeros(1, 32), args[5])
    with pytest.raises(ValueError):
        fused_gru_scan_inproj(*args[:5], args[5][:, :-1])
    with pytest.raises(ValueError):
        fused_gru_scan_inproj_backward(*args, ys[:, :, :-1], *map(_t, cots))


def test_rnn_gru_matches_jax():
    """``rnn.gru`` on a transposed (non-contiguous) input, from zeros and
    from a given state, against JAX ``rnn.gru(use_pallas=True)``: outputs,
    final state and the gradients of the four weights at atol 1e-5 (bf16:
    tests/test_torch_fullsubnet_bf16.py)."""
    rng = np.random.default_rng(3)
    T, B, In, H = 8, 3, 10, 12
    k = 1 / np.sqrt(H)
    w = [rng.uniform(-k, k, s).astype(np.float32)
         for s in ((3 * H, In), (3 * H, H), (3 * H,), (3 * H,))]
    x = rng.standard_normal((B, T, In)).astype(np.float32)
    h0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    dys = rng.standard_normal((T, B, H)).astype(np.float32)

    for state in (None, h0):
        def jloss(params, xx):
            ys, hT = jrnn.gru(jrnn.LstmParams(*params), xx.swapaxes(0, 1),
                              None if state is None else jnp.asarray(state), use_pallas=True)
            return jnp.sum(ys * dys) + jnp.sum(hT), (ys, hT)

        (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(
            [jnp.asarray(a) for a in w], jnp.asarray(x))
        params = [_t(a).requires_grad_() for a in w]
        ys, hT = trnn.gru(trnn.LstmParams(*params), _t(x).transpose(0, 1),
                          None if state is None else _t(state))
        loss = (ys * _t(dys)).sum() + hT.sum()
        grads = torch.autograd.grad(loss, params)
        for g, want in zip((ys, hT, *grads), (*jout, *jgrads)):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(want), atol=1e-5)


# --- DSP and the feature ops -----------------------------------------------------


@pytest.mark.parametrize("length", [None, 3000, 4100], ids=["no-length", "length", "zero-fill"])
def test_framework_stft_istft_match_jax(length):
    """stft (centre, reflect padding, periodic Hann(48) centred in 64, hop
    36) at atol 1e-5; istft with its least-squares envelope, the length
    crop and the zero fill past the reconstructable span at atol 1e-5; the
    magnitude of a spectrum at atol 1e-5 and its phase, where the magnitude
    exceeds 1e-3, at 1e-4.  Also a signal shorter
    than the reflect pad, which reflects back and forth through it."""
    rng = np.random.default_rng(5)
    y = rng.standard_normal((2, 3000)).astype(np.float32)
    spec_j = frame_stft(jnp.asarray(y), 64, 36, 48)
    spec = stft(_t(y), 64, 36, 48)
    np.testing.assert_allclose(spec.numpy(), np.asarray(spec_j), atol=1e-5)
    out_j = frame_istft(spec_j, 64, 36, 48, length=length)
    out = istft(spec, 64, 36, 48, length=length)
    assert tuple(out.shape) == out_j.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-5)
    both = istft(torch.stack([spec.real, spec.imag], -1), 64, 36, 48, length=length)
    assert torch.equal(both, out)
    mag, phase = mag_phase(spec)
    np.testing.assert_allclose(mag.numpy(), np.abs(np.asarray(spec_j)), atol=1e-5)
    # phases compared modulo 2 pi: a real negative bin may sit at +pi or -pi
    wrapped = np.angle(np.exp(1j * (phase.numpy() - np.angle(np.asarray(spec_j)))))
    assert np.abs(wrapped[mag.numpy() > 1e-3]).max() <= 1e-4
    short = y[:, :20]
    np.testing.assert_allclose(stft(_t(short), 64, 36, 48).numpy(),
                               np.asarray(frame_stft(jnp.asarray(short), 64, 36, 48)), atol=1e-5)


def test_cirm_matches_jax():
    """Build (with the -100 clamp reached), compress and decompress (with
    the 9.9 limit reached) at rtol 1e-5, atol 1e-5."""
    rng = np.random.default_rng(6)
    noisy = (rng.standard_normal((2, 5, 7)) + 1j * rng.standard_normal((2, 5, 7))).astype(np.complex64)
    clean = (rng.standard_normal((2, 5, 7)) + 1j * rng.standard_normal((2, 5, 7))).astype(np.complex64)
    noisy[0, 0, 0] = 1e-4  # a mask far below -100 after the ratio
    clean[0, 0, 0] = -1.0
    got = cirm.build_complex_ideal_ratio_mask(_t(noisy), _t(clean))
    want = jcirm.build_complex_ideal_ratio_mask(jnp.asarray(noisy), jnp.asarray(clean))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    mask = np.concatenate([rng.standard_normal(20) * 4, [-150.0, 12.0, -12.0, 9.95]]).astype(np.float32)
    np.testing.assert_allclose(cirm.compress_cIRM(_t(mask)).numpy(),
                               np.asarray(jcirm.compress_cIRM(jnp.asarray(mask))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cirm.decompress_cIRM(_t(mask)).numpy(),
                               np.asarray(jcirm.decompress_cIRM(jnp.asarray(mask))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [0, 3])
def test_unfold_matches_jax(n):
    """Exact: a gather (n = 3, reflect padding) or a transpose (n = 0)."""
    x = np.random.default_rng(7).standard_normal((3, 2, 11, 5)).astype(np.float32)
    got = unfold.unfold(_t(x), n)
    want = junfold(jnp.asarray(x), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("valid", ["none", "scalar", "per-sample"])
@pytest.mark.parametrize("name", ["offline_laplace_norm", "cumulative_laplace_norm",
                                  "offline_gaussian_norm", "cumulative_layer_norm"])
def test_norms_match_jax(name, valid):
    """Each of ``norm_wrapper``'s four norms, with no, a scalar and a
    per-sample ``valid_frames``, at rtol 1e-5, atol 1e-6 (f32 statistics)."""
    x = np.abs(np.random.default_rng(9).standard_normal((3, 2, 6, 11))).astype(np.float32)
    vf = {"none": None, "scalar": 7, "per-sample": np.array([11, 4, 8])}[valid]
    got = norms.norm_wrapper(name)(_t(x), valid_frames=vf)
    want = jnorms.norm_wrapper(name)(jnp.asarray(x), valid_frames=vf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


# --- weights ----------------------------------------------------------------------


def _cfgs(seq="GRU", accum=1, dropout_rate=0.0, **fsn):
    fsn = {**TINY_FSN, "dropout": dropout_rate, **fsn}
    common = dict(model="FullSubNet", loss="MSE", sequence_model=seq)
    return (
        JConfig(**common, stft=JStftConfig(**TINY_STFT), fullsubnet=JFullSubNetConfig(**fsn),
                use_pallas_lstm="off", train=JTrainConfig(learning_rate=LR, grad_accum=accum)),
        Config(**common, stft=StftConfig(**TINY_STFT), fullsubnet=FullSubNetConfig(**fsn),
               train=TrainConfig(learning_rate=LR, grad_accum=accum)),
    )


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(0)
    clean = (rng.standard_normal((2, 4000)) * 0.1).astype(np.float32)  # 0.25 s
    noisy = (clean + rng.standard_normal((2, 4000)) * 0.05).astype(np.float32)
    return types.SimpleNamespace(
        trees={seq: random_fullsubnet_params(_cfgs(seq)[1], seed=0) for seq in ("LSTM", "GRU")},
        noisy=noisy, clean=clean,
    )


@pytest.mark.parametrize("seq", ["LSTM", "GRU"])
def test_random_tree_has_flax_layout_and_carries_over(tiny, seq):
    """The numpy tree has flax's layout; the carried-over state dict equals
    the JAX exporter's key for key and value for value and loads strictly."""
    jcfg, cfg = _cfgs(seq)
    shapes = jax.eval_shape(lambda: jbuild_model(jcfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 33, 20)), train=False))
    params, bstats = tiny.trees[seq]
    assert jax.tree.map(np.shape, {"params": params}) == jax.tree.map(lambda s: s.shape, dict(shapes))
    assert bstats == {}
    want = export_reference_state_dict(params, bstats, jcfg)
    got = state_dict_from_jax(params, bstats, cfg)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    build_model(cfg, device="cpu").load_state_dict(got, strict=True)


# --- the tiny model against JAX -----------------------------------------------------


def _port(tiny, cfg):
    return create_train_state(cfg, state_dict_from_jax(*tiny.trees[cfg.sequence_model], cfg),
                              device="cpu")


def _mag(tiny):
    return np.abs(np.asarray(frame_stft(jnp.asarray(tiny.noisy), 64, 36, 48)))


@pytest.mark.parametrize("seq", ["LSTM", "GRU"])
def test_forward_matches_jax(tiny, seq):
    """The cRM ``[B, F, T, 2]`` at atol 1e-4, without ``valid_frames`` and
    with per-sample ones (the masked frames zeroed and left out of the
    offline norm's statistics); the valid prefix of the masked run then
    matches a run on the cropped input at atol 1e-4."""
    jcfg, cfg = _cfgs(seq)
    params, _ = tiny.trees[seq]
    mag = _mag(tiny)
    vf = np.array([mag.shape[-1], 60])
    jmodel = jbuild_model(jcfg)
    m, _ = _port(tiny, cfg)
    apply = jax.jit(lambda m_, vf_: jmodel.apply({"params": params}, m_, train=False,
                                                 valid_frames=vf_))
    with torch.inference_mode():
        for valid in (None, vf):
            want = apply(jnp.asarray(mag), None if valid is None else jnp.asarray(valid))
            got = m(_t(mag), valid_frames=valid)
            assert tuple(got.shape) == want.shape == (2, 33, mag.shape[-1], 2)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        cropped = m(_t(mag[1:, :, :60]))
        np.testing.assert_allclose(got[1:, :, :60].numpy(), cropped.numpy(), atol=1e-4)


def test_eval_step_matches_jax(tiny):
    """FullSubNet-GRU's eval step: the MSE between cIRM and cRM at rtol
    1e-4, the enhanced waveform (cRM decode, complex multiply, iSTFT at the
    input's length) at atol 1e-4."""
    jcfg, cfg = _cfgs("GRU")
    params, bstats = tiny.trees["GRU"]
    tx = jmake_optimizer(jcfg)
    state = TrainState(step=0, params=params, batch_stats=bstats, opt_state=None, tx=tx)
    want_m, want_wav = make_eval_step(jcfg, jbuild_model(jcfg))(
        state, jnp.asarray(tiny.noisy), jnp.asarray(tiny.clean))
    m, _ = _port(tiny, cfg)
    got_m, wav = eval_step(cfg, m, tiny.noisy, tiny.clean)
    np.testing.assert_allclose(got_m["loss"].item(), float(want_m["loss"]), rtol=1e-4)
    assert tuple(wav.shape) == want_wav.shape == tiny.noisy.shape
    np.testing.assert_allclose(wav.numpy(), np.asarray(want_wav), atol=1e-4)
    np.testing.assert_allclose(enhance_batch(m, tiny.noisy, device="cpu").numpy(),
                               wav.numpy(), atol=1e-6)


@pytest.mark.parametrize("seq,accum", [("LSTM", 1), ("GRU", 1), ("GRU", 2)],
                         ids=["lstm", "gru", "gru-accum2"])
def test_train_step_matches_jax(tiny, seq, accum):
    """One ``train_step`` (dropout 0) against the JAX package's jitted
    ``make_train_step`` (Adam, lr 1e-3): loss at rtol 1e-4; every gradient
    leaf, the mean of the micro-batches' under accumulation, within 1e-3 of
    its max from ``jax.grad``; every parameter within 2 lr and at most 0.1%
    of entries off by more than 1e-5 (Adam's first step is about lr *
    sign(g), and a roundoff-level gradient's sign can flip)."""
    jcfg, cfg = _cfgs(seq, accum)
    params, bstats = tiny.trees[seq]
    jmodel = jbuild_model(jcfg)
    tx = jmake_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, params)

    @jax.jit
    def grads_of(x, y):
        return jax.grad(lambda p: _loss_and_outputs(
            jcfg, jmodel, p, {}, x, y, train=True, dropout_rng=None)[0])(jp)

    halves = [grads_of(jnp.asarray(x), jnp.asarray(y))
              for x, y in zip(np.split(tiny.noisy, accum), np.split(tiny.clean, accum))]
    jgrads = jax.tree.map(lambda *g: sum(g) / accum, *halves)
    state = TrainState(step=0, params=jp, batch_stats=bstats, opt_state=tx.init(jp), tx=tx)
    # the step donates its state: nothing reads jp after it
    new_state, metrics = make_train_step(jcfg, jmodel)(
        state, jnp.asarray(tiny.noisy), jnp.asarray(tiny.clean), jax.random.PRNGKey(0))
    want_g = {k: v.numpy() for k, v in state_dict_from_jax(jgrads, {}, cfg).items()}
    want_p = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, new_state.params), {}, cfg).items()}

    m, opt = _port(tiny, cfg)
    got = train_step(cfg, m, opt, tiny.noisy, tiny.clean)
    np.testing.assert_allclose(got["loss"].item(), float(metrics["loss"]), rtol=1e-4)
    for k, p in m.named_parameters():
        err = np.abs(p.grad.numpy() - want_g[k]).max()
        assert err <= 1e-3 * np.abs(want_g[k]).max(), (k, err)
    deltas = np.concatenate([np.abs(p.detach().numpy() - want_p[k]).ravel()
                             for k, p in m.named_parameters()])
    assert deltas.max() <= 2 * LR
    assert np.mean(deltas > 1e-5) <= 1e-3, np.mean(deltas > 1e-5)


# --- dropout ------------------------------------------------------------------------


@pytest.mark.parametrize("cls", [TorchLSTM, TorchGRU])
def test_dropout_between_layers(cls):
    """In train mode the same generator seed gives the same output, another
    seed another; no generator raises; eval mode applies none.  The mask
    itself keeps about 1 - 0.8 of the values, each scaled by 5, as
    ``flax.linen.Dropout``."""
    rnn = cls(6, 8, num_layers=2, dropout=0.8, generator=torch.Generator().manual_seed(0))
    x = torch.randn(5, 3, 6, generator=torch.Generator().manual_seed(1))
    gen = lambda seed: torch.Generator().manual_seed(seed)
    rnn.train()
    a, b, c = rnn(x, gen(3)), rnn(x, gen(3)), rnn(x, gen(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        rnn(x)
    rnn.eval()
    assert torch.equal(rnn(x), rnn(x, gen(3)))
    ones = torch.ones(200, 500)
    y = dropout(ones, 0.8, gen(5))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.2) < 0.01
    assert torch.all(y[kept] == 5.0)


def test_train_step_draws_fresh_dropout_masks(tiny):
    """With dropout 0.8 the default generator lives on the model, seeded
    from ``cfg.train.seed``: two models step alike, and a second step draws
    new masks; an explicit generator with the same seed gives the same
    step."""
    _, cfg = _cfgs("GRU", dropout_rate=0.8)
    losses = []
    for gen in (None, None, torch.Generator().manual_seed(cfg.train.seed)):
        m, opt = _port(tiny, cfg)
        losses.append(train_step(cfg, m, opt, tiny.noisy, tiny.clean, gen)["loss"].item())
    assert losses[0] == losses[1] == losses[2]
    m, opt = _port(tiny, cfg)
    assert not hasattr(m, "dropout_generator")
    train_step(cfg, m, opt, tiny.noisy, tiny.clean)
    state = m.dropout_generator.get_state()
    train_step(cfg, m, opt, tiny.noisy, tiny.clean)
    assert not torch.equal(state, m.dropout_generator.get_state())


# --- the CLI and what is left out ---------------------------------------------------


def test_enhance_cli_fullsubnet_buckets_exactly(tiny, tmp_path, monkeypatch):
    """``--model FullSubNet --sequence-model GRU --batch 2`` with the offline
    norm (run in process, at the tiny width): two files of one bucket go
    through one buffer of ``ceil((L + fft_len / 2) / fs) * fs`` samples,
    whose first ``fft_len / 2`` pad samples reflect the tail, with
    per-sample ``valid_frames``.  Each output matches ``enhance_batch`` on
    that buffer within 2 int16 LSBs (the JAX CLI's ``--batch`` contract),
    and ``enhance_batch`` at the file's exact length within 2 LSBs but in
    the last analysis window (``fft_len`` samples), which the padded run's
    extra frames reach, as in the JAX CLI.  A file of at most
    ``fft_len // 2`` samples runs at its exact length."""
    _, cfg = _cfgs("GRU")
    monkeypatch.setattr(tenhance, "Config", functools.partial(Config, stft=StftConfig(**TINY_STFT)))
    monkeypatch.setattr(tenhance, "FullSubNetConfig", functools.partial(FullSubNetConfig, **TINY_FSN))
    sd = state_dict_from_jax(*tiny.trees["GRU"], cfg)
    ckpt = save_reference_checkpoint(str(tmp_path / "fsn.pt"), sd)
    rng = np.random.default_rng(10)
    lengths = {"a.wav": 5000, "b.wav": 7100, "c.wav": 30}
    for name, L in lengths.items():
        write_wav(str(tmp_path / name), rng.standard_normal(L) * 0.1, cfg.stft.fs)
    tenhance.main(["--checkpoint", ckpt, "--model", "FullSubNet", "--sequence-model", "GRU",
                   "--batch", "2", "--device", "cpu",
                   *[str(tmp_path / n) for n in lengths], "--out-dir", str(tmp_path / "out")])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    wavs = {n: read_wav(str(tmp_path / n))[0].astype(np.float32) for n in lengths}
    bufs, frames = [], []
    for name in ("a.wav", "b.wav"):
        x = wavs[name]
        L = len(x)
        buf = np.zeros(16000, np.float32)
        buf[:L] = x
        buf[L : L + 32] = x[L - 33 : L - 1][::-1]  # x[L+k] = x[L-2-k]
        bufs.append(buf)
        frames.append(1 + L // 36)
    bucketed = enhance_batch(model, np.stack(bufs), device="cpu", valid_frames=np.array(frames))
    lsb = lambda y: np.clip(y * 32768, -32768, 32767).astype(np.int16) / 32768.0
    for i, name in enumerate(("a.wav", "b.wav", "c.wav")):
        L = lengths[name]
        got = read_wav(str(tmp_path / "out" / name))[0]
        exact = enhance_batch(model, wavs[name][None], device="cpu")[0].numpy()
        assert got.shape == (L,)
        if name == "c.wav":  # the short file: its exact-length run
            np.testing.assert_allclose(got, lsb(exact), atol=2 / 32768)
            continue
        np.testing.assert_allclose(got, lsb(bucketed[i, :L].numpy()), atol=2 / 32768, err_msg=name)
        np.testing.assert_allclose(got[: L - 64], lsb(exact)[: L - 64], atol=2 / 32768, err_msg=name)


def test_fullsubnet_entry_points_default_to_cuda(tiny, tmp_path):
    """Without a card, ``build_model``, ``create_train_state``,
    ``enhance_batch`` and the CLI raise for FullSubNet unless asked for the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a CUDA device")
    _, cfg = _cfgs("GRU")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        create_train_state(cfg)
    model, _ = _port(tiny, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        enhance_batch(model, tiny.noisy)
    with pytest.raises(SystemExit):
        tenhance.main(["--checkpoint", str(tmp_path / "unused.pt"), "--model", "FullSubNet",
                       "--sequence-model", "GRU", str(tmp_path / "unused.wav")])


def test_pieces_left_out_raise():
    """The EMA norms (not in ``norm_wrapper``'s table, as in the JAX package)
    and FullSubNet with a perceptual loss raise.  weight_init=True, once
    left out, builds: it redraws the weights
    (tests/test_torch_fsn_extras.py holds it to the reference's table; bf16
    is ported: tests/test_torch_fullsubnet_bf16.py)."""
    _, cfg = _cfgs("GRU")
    wi = build_model(cfg.replace(fullsubnet=FullSubNetConfig(**TINY_FSN, weight_init=True)),
                     device="cpu").state_dict()
    plain = build_model(cfg, device="cpu").state_dict()
    assert wi.keys() == plain.keys() and all(not torch.equal(wi[k], plain[k]) for k in wi)
    with pytest.raises(NotImplementedError):
        norms.norm_wrapper("forgetting_norm")
    with pytest.raises(ValueError, match="perceptual"):
        cfg.replace(perceptual="LMS")
