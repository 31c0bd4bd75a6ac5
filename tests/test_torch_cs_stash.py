"""K2's bf16 cell-state stash (``SE_TPU_LSTM_CS_STASH=bfloat16``) in the
PyTorch port against the JAX package on the CPU: the in-projection LSTM
scan's plain forward and backward with the stash in f32 and in bf16, in
both stream forms, against ``jax.vjp`` of the Pallas kernel run in
interpret mode with ``CS_STASH_DTYPE`` set alike in both packages; the
rounding itself (the carry stays f32, only the stored ``cs`` is rounded);
the wrapper's ``cs_dtype`` keyword and its import-time default; and a tiny
CRN's gradients with the stash on in both packages."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from se_tpu.config import Config as JConfig, CrnConfig as JCrnConfig, DccrnConfig as JDccrnConfig
from se_tpu.models import build_model as jbuild_model
from se_tpu.ops import pallas_lstm
from se_tpu.train.steps import _loss_and_outputs

from se_tpu_torch.config import Config, CrnConfig, DccrnConfig
from se_tpu_torch.losses import main_loss
from se_tpu_torch.ops import fused_lstm_inproj
from se_tpu_torch.ops.fused_lstm_inproj import (
    fused_lstm_scan_inproj,
    fused_lstm_scan_inproj_backward,
    fused_lstm_scan_inproj_backward_reference,
)
from se_tpu_torch.train.state import create_train_state
from se_tpu_torch.utils.weights import random_crn_params, state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_NAMES = ("dx", "dw_ih_t", "dbias", "dw_hh_t", "dh0", "dc0")
# tests/test_pallas_lstm.py::test_inproj_bf16_cs_stash_grads_close's shapes
SHAPE = (10, 1, 8, 8, 16)  # T, L, Bb, In, H
# both packages round the same f32 values to the same bf16 ones
PARITY_TOL = 1e-6  # of each leaf's max
STASH_TOL = 5e-3  # bf16 against f32 stash, of each leaf's max (the reference's own bound)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run gives each of its workers a share of the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(T, L, Bb, In, H, seed=3):
    """Forward inputs (torch's init range, nonzero h0 and c0) and seeded
    cotangents of (ys, hT, cT), as numpy f32."""
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


def _leaf_err(got, want) -> float:
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ulps(got, want) -> float:
    """max over elements of |got - want| in bf16 ulps of max(|got|, |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.ldexp(np.float32(1.0), np.frexp(mag)[1] - 8)
    return float(np.max(np.abs(got - want) / np.maximum(ulp, np.finfo(np.float32).tiny)))


def _hold(name, got, want):
    """A bf16 leaf within one bf16 ulp (two sums in another f32 order may
    tip a rounding), an f32 leaf within 1e-6 of its max."""
    w = np.asarray(jnp.asarray(want, jnp.float32))
    g = got.detach().float().numpy()
    assert g.shape == w.shape, name
    if got.dtype == torch.bfloat16:
        assert _ulps(g, w) <= 1.0, (name, _ulps(g, w))
    else:
        assert _leaf_err(g, w) <= PARITY_TOL, (name, _leaf_err(g, w))


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("stash", ["f32", "bf16"])
def test_stash_matches_pallas_in_both_stream_forms(monkeypatch, stash, stream):
    """With ``CS_STASH_DTYPE`` set alike in both packages, the port's plain
    forward (ys, the stash cs, hT, cT) against the Pallas kernel's
    (interpret mode), and the port's plain backward on the Pallas forward's
    own residuals (so that both read the same rounded stash) against the
    Pallas backward: every f32 leaf within 1e-6 of its max, every bf16 leaf
    (ys and dx in the bf16-stream form, a bf16 stash) within one bf16 ulp.
    ys, dx in the stream's dtype, cs in the stash's, the rest f32."""
    monkeypatch.setattr(pallas_lstm, "CS_STASH_DTYPE", DTYPES[stash][1])
    monkeypatch.setattr(fused_lstm_inproj, "CS_STASH_DTYPE", DTYPES[stash][0])
    tdt, jdt = DTYPES[stream]
    inputs, cots = _case(*SHAPE)
    jin = [jnp.asarray(inputs[0]).astype(jdt), *map(jnp.asarray, inputs[1:])]
    jcots = (jnp.asarray(cots[0]).astype(jdt), (jnp.asarray(cots[1]), jnp.asarray(cots[2])))
    # fresh functions to jit: a cached trace would keep the last stash dtype
    (ys_j, (hT_j, cT_j)), res = jax.jit(lambda *a: pallas_lstm._inproj_fwd(*a))(*jin)
    grads_j = jax.jit(lambda *a: pallas_lstm._inproj_bwd(*a))(res, jcots)
    assert res[-1].dtype == DTYPES[stash][1]

    args = [torch.from_numpy(a) for a in inputs]
    args[0] = args[0].to(tdt)
    ys, cs, hT, cT = fused_lstm_inproj._forward(*args, need_cs=True)
    assert (ys.dtype, cs.dtype, hT.dtype, cT.dtype) == (tdt, DTYPES[stash][0], torch.float32,
                                                         torch.float32)
    for name, g, w in zip(("ys", "cs", "hT", "cT"), (ys, cs, hT, cT),
                          (ys_j, res[-1], hT_j, cT_j)):
        _hold(name, g, w)

    t_res = [torch.from_numpy(np.array(jnp.asarray(r, jnp.float32))) for r in res]
    t_res[0], t_res[-2] = t_res[0].to(tdt), t_res[-2].to(tdt)  # the stream, ys
    t_res[-1] = t_res[-1].to(DTYPES[stash][0])  # exact: the stash's own values
    dys, dhT, dcT = (torch.from_numpy(c) for c in cots)
    grads = fused_lstm_scan_inproj_backward(*t_res, dys.to(tdt), dhT, dcT)
    assert grads[0].dtype == tdt and all(g.dtype == torch.float32 for g in grads[1:])
    for name, g, w in zip(GRAD_NAMES, grads, grads_j):
        _hold(name, g, w)


def test_bf16_stash_rounds_only_what_is_stored():
    """The bf16 stash is the f32 stash rounded to nearest even; ys, hT and
    cT keep their bits (the carry stays f32).  The backward reads c_t and
    c_prev at t > 0 from the rounded stash and c_prev at t = 0 from c0: it
    equals the f32 backward fed the rounded values widened back; its
    gradients lie within the reference's 5e-3 of each leaf's max of the
    f32 stash's."""
    inputs, cots = _case(*SHAPE)
    args = [torch.from_numpy(a) for a in inputs]
    cots = [torch.from_numpy(c) for c in cots]
    ref = fused_lstm_inproj._reference_forward
    ys, cs32, hT, cT = ref(*args, need_cs=True)
    ys16, cs16, hT16, cT16 = ref(*args, need_cs=True, cs_dtype=torch.bfloat16)
    assert cs32.dtype == torch.float32 and cs16.dtype == torch.bfloat16
    assert torch.equal(cs16, cs32.to(torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in ((ys, ys16), (hT, hT16), (cT, cT16)))
    assert not torch.equal(cs16.float(), cs32)  # the rounding moved something

    g16 = fused_lstm_scan_inproj_backward(*args, ys, cs16, *cots, cs_dtype=torch.bfloat16)
    widened = fused_lstm_scan_inproj_backward_reference(*args, ys, cs16.float(), *cots)
    assert all(torch.equal(a, b) for a, b in zip(g16, widened))
    g32 = fused_lstm_scan_inproj_backward(*args, ys, cs32, *cots, cs_dtype=torch.float32)
    errs = {n: _leaf_err(a.numpy(), b.numpy()) for n, a, b in zip(GRAD_NAMES, g16, g32)}
    assert 0 < max(errs.values()) <= STASH_TOL, errs


def test_cs_dtype_keyword_and_import_default(monkeypatch):
    """``CS_STASH_DTYPE`` is read at import from ``SE_TPU_LSTM_CS_STASH``:
    ``bfloat16`` gives bf16, anything else f32.  ``cs_dtype`` overrides it
    in the forward (the Function saves the stash in that dtype) and in the
    backward, which rejects a stash of another dtype; CPU tensors count no
    launch; float16 is not a stash dtype."""
    probe = ("import torch; from se_tpu_torch.ops import fused_lstm_inproj as m; "
             "print(m.CS_STASH_DTYPE)")
    seen = []
    for value in ("bfloat16", "float16"):
        env = {**os.environ, "SE_TPU_LSTM_CS_STASH": value, "PYTHONPATH": REPO}
        out = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True,
                             text=True, check=True, cwd=REPO)
        seen.append(out.stdout.strip())
    assert seen == ["torch.bfloat16", "torch.float32"]
    want = (torch.bfloat16 if os.environ.get("SE_TPU_LSTM_CS_STASH") == "bfloat16"
            else torch.float32)
    assert fused_lstm_inproj.CS_STASH_DTYPE == want

    inputs, cots = _case(5, 1, 3, 6, 8, seed=2)
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    counts = lambda: [getattr(fn, a) for fn in (fused_lstm_scan_inproj,
                                               fused_lstm_scan_inproj_backward)
                      for a in ("launches", "launches_bf16", "launches_cs16",
                                "launches_bf16_cs16")]
    before = counts()
    for constant, keyword, saved in ((torch.float32, torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, None, torch.bfloat16),
                                     (torch.bfloat16, torch.float32, torch.float32)):
        monkeypatch.setattr(fused_lstm_inproj, "CS_STASH_DTYPE", constant)
        ys, (hT, cT) = fused_lstm_scan_inproj(*leaves, cs_dtype=keyword)
        assert ys.grad_fn.saved_tensors[-1].dtype == saved
        (ys.sum() + hT.sum()).backward()
    assert counts() == before

    args = [torch.from_numpy(a) for a in inputs]
    ys, cs, _, _ = fused_lstm_inproj._reference_forward(*args, need_cs=True)
    monkeypatch.setattr(fused_lstm_inproj, "CS_STASH_DTYPE", torch.float32)
    with pytest.raises(TypeError, match="cs must be"):
        fused_lstm_scan_inproj_backward(*args, ys, cs, None, None, None, cs_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="stash"):
        fused_lstm_scan_inproj(*args, cs_dtype=torch.float16)


def test_crn_gradients_with_the_bf16_stash_match_jax(monkeypatch):
    """A tiny CRN's MSE loss and gradients with the bf16 stash on in both
    packages (JAX: ``use_pallas_lstm="on"``, interpret mode), at
    ``tests/test_torch_crn.py``'s tolerances: the loss at rtol 1e-4, each
    leaf within 1e-3 of its JAX max, the BatchNorm-cancelled conv biases
    below 1e-5 of the largest gradient."""
    monkeypatch.setattr(pallas_lstm, "CS_STASH_DTYPE", jnp.bfloat16)
    monkeypatch.setattr(fused_lstm_inproj, "CS_STASH_DTYPE", torch.bfloat16)
    common = dict(model="CRN", loss="MSE", lstm="real", masking_mode="E")
    crn = dict(rnn_input_size=256, rnn_units=32)  # C x D after three stages: 8 x 32
    dccrn = dict(kernel_num=(8, 16, 16), rnn_units=32)
    jcfg = JConfig(**common, crn=JCrnConfig(**crn), dccrn=JDccrnConfig(**dccrn),
                   use_pallas_lstm="on")
    cfg = Config(**common, crn=CrnConfig(**crn), dccrn=DccrnConfig(**dccrn))
    rng = np.random.default_rng(0)
    clean = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    noisy = (clean + rng.standard_normal((2, 8000)) * 0.05).astype(np.float32)
    params, bstats = random_crn_params(cfg, seed=0)
    jmodel = jbuild_model(jcfg)

    def loss_fn(p):
        loss, _ = _loss_and_outputs(jcfg, jmodel, p, jax.tree.map(jnp.asarray, bstats),
                                    jnp.asarray(noisy), jnp.asarray(clean), train=True,
                                    dropout_rng=None)
        return loss

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.array, grads), jax.tree.map(np.array, bstats), cfg).items()}

    model, _ = create_train_state(cfg, state_dict_from_jax(params, bstats, cfg), device="cpu")
    model.train()
    stashes, real = [], fused_lstm_inproj._reference_forward

    def spy(*a):  # (..., need_cs, cs_dtype)
        stashes.append(a[7] if a[6] else None)
        return real(*a)

    monkeypatch.setattr(fused_lstm_inproj, "_reference_forward", spy)
    out = model(torch.from_numpy(noisy))[-1]
    loss = main_loss(cfg.loss, out, torch.from_numpy(clean))
    loss.backward()
    assert stashes == [torch.bfloat16]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    sd = model.state_dict()
    cancelled = {k for k in sd if k.endswith("conv.bias")
                 and k.rsplit(".", 3)[0] + ".1.running_mean" in sd}
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    scale = max(np.abs(want[k]).max() for k in got)
    for k, g in got.items():
        if k in cancelled:
            assert max(np.abs(g).max(), np.abs(want[k]).max()) <= 1e-5 * scale, k
        else:
            assert np.abs(g - want[k]).max() <= 1e-3 * np.abs(want[k]).max(), k
