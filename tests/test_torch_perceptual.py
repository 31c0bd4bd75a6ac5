"""The PyTorch port's perceptual losses and the ``perceptual`` trainer
variant (se_tpu_torch) against the JAX package on the CPU: LMS and PMSQE,
value and gradient; the perceptual train step of a tiny DCCRN and CRN with
each loss, with and without gradient accumulation; the train CLI's log entry
for a perceptual run; and the train CLI's one remaining unported flag.

The JAX side is jitted; its LSTM kernels run in interpret mode
(``use_pallas_lstm="on"``).  Losses are held at rtol 1e-4 and LMS's
gradients at atol 1e-5, rtol 1e-4.  Two gradients need more, for reasons of
their own, each measured here:

* PMSQE's gradient within 1e-3 of its largest: the level alignment scales
  the spectra to ~1e7 and the normalisations sum terms of both signs in
  f32, so the port's f32 gradient and its own f64 one differ by up to
  1.8e-4 of the largest.  Its P.862 gates are discontinuous: where one
  sits within f32 rounding of its threshold it can take the other branch in
  one analysis frame (at 3 s, 337 samples of one frame, and the port's f64
  gradient flips the same frame against its f32 one), so the samples past
  1e-3 must all lie within one 512-sample frame.
* The train steps' gradients (read back from JAX's Adam moment) within 1e-3
  of max(the leaf's largest, 1e-2 x the model's largest), the rule
  ``chip_smoke.py`` holds a card's step to the CPU's by: a PReLU slope sums
  products of both signs, and its error is set by their size.  CRN with LMS
  within 1e-2 (measured 3.5e-3): its random tanh masks leave ~90% of the
  mel values at or below 0, and the few just above 0 sit where the log's
  derivative, 1 / (x + 1e-7), is ~5e6, which multiplies the two packages'
  f32 forward difference (3.5e-5 in the estimated magnitudes)."""

import os
import re
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
from se_tpu.losses.lms import lms_loss as jlms_loss
from se_tpu.losses.pmsqe import pmsqe_loss as jpmsqe_loss
from se_tpu.models import build_model as jbuild_model
from se_tpu.train import loop as jloop
from se_tpu.train.state import TrainState, make_optimizer as jmake_optimizer
from se_tpu.train.steps import make_train_step

from se_tpu_torch import train_interface
from se_tpu_torch.config import Config, CrnConfig, DccrnConfig, TrainConfig
from se_tpu_torch.losses import perceptual_loss
from se_tpu_torch.losses.lms import lms_loss
from se_tpu_torch.losses.pmsqe import pmsqe_loss
from se_tpu_torch.train.state import create_train_state
from se_tpu_torch.train.steps import eval_step, train_step
from se_tpu_torch.utils.weights import random_crn_params, random_dccrn_params, state_dict_from_jax

TINY_KN = (8, 16, 16)
TINY_CRN = dict(rnn_input_size=256, rnn_units=32)
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


def _speech(n, L, rng):
    """Amplitude-modulated harmonic stacks, peak 0.3."""
    t = np.arange(L) / 16000
    out = []
    for _ in range(n):
        f0 = rng.uniform(100, 250)
        sig = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi)) / k
                  for k in range(1, 8))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
        out.append(0.3 * env * sig / np.abs(sig).max())
    return np.stack(out).astype(np.float32)


# --- LMS -------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["time-major", "scrambled", "tie"])
def test_lms_matches_jax(case):
    """Value at rtol 1e-4; the gradients of both magnitude arrays at atol
    1e-5, rtol 1e-4.  Negative estimates (CRN's tanh masks) are clamped to 0
    before the log.  ``tie``: frames of exactly 0, where the clamp's maximum
    ties; ``jnp.maximum`` hands each side half the gradient there, and so
    must the port (a ``clamp_min`` would hand all of it), so those frames'
    gradients are large and must match."""
    rng = np.random.default_rng(0)
    clean = rng.uniform(0.0, 2.0, (2, 257, 30)).astype(np.float32)
    est = rng.uniform(-0.5, 2.0, (2, 257, 30)).astype(np.float32)
    if case == "tie":
        est[:, :, 3] = 0.0
        est[1, :, 17] = 0.0
    scrambled = case == "scrambled"
    value, grads = jax.value_and_grad(
        lambda c, e: jlms_loss(c, e, compat_scrambled=scrambled), argnums=(0, 1))(
        jnp.asarray(clean), jnp.asarray(est))
    c, e = _t(clean).requires_grad_(), _t(est).requires_grad_()
    got = lms_loss(c, e, compat_scrambled=scrambled)
    got.backward()
    np.testing.assert_allclose(got.item(), float(value), rtol=1e-4)
    for g, w in zip((c.grad, e.grad), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4)
    if case == "tie":
        tie = np.abs(e.grad.numpy()[:, :, 3]).max()
        assert tie > 1.0, tie  # the zero frame's gradient flows, at half weight


def test_lms_through_the_dispatch_needs_magnitudes():
    with pytest.raises(ValueError, match="magnitudes"):
        perceptual_loss("LMS", torch.zeros(1, 800), torch.zeros(1, 800))
    with pytest.raises(ValueError, match="unknown"):
        perceptual_loss("STOI", torch.zeros(1, 800), torch.zeros(1, 800))


# --- PMSQE -----------------------------------------------------------------------


@pytest.mark.parametrize("L,identical", [(16000, False), (48000, False), (24000, False),
                                         (48000, True)],
                         ids=["1s", "3s", "1.5s-trimmed", "identical"])
def test_pmsqe_matches_jax(L, identical):
    """Value at rtol 1e-4 and the degraded waveform's gradient within 1e-3 of
    its largest but in at most one analysis frame of each row (a gate on the
    other branch, see the module's docstring), at 1 s, at 3 s (three 1-s
    chunks), at 1.5 s (trimmed to its whole second: the last half second
    gets no gradient) and at deg == ref, where the loss is exactly 0 and the
    gradient finite (the dead zone's ``where`` keeps sqrt'(0) out of it)."""
    rng = np.random.default_rng(L + identical)
    ref = _speech(2, L, rng)
    deg = ref.copy() if identical else (ref + 0.02 * rng.standard_normal(ref.shape)).astype(
        np.float32)
    value, grad = jax.value_and_grad(lambda d: jpmsqe_loss(jnp.asarray(ref), d))(
        jnp.asarray(deg))
    d = _t(deg).requires_grad_()
    got = pmsqe_loss(_t(ref), d)
    got.backward()
    g, w = d.grad.numpy(), np.asarray(grad)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(got.item(), float(value), rtol=1e-4)
    if identical:
        assert got.item() == 0.0 and float(value) == 0.0
        np.testing.assert_array_equal(g, w)
    else:
        for row, (gr, wr) in enumerate(zip(g, w)):
            off = np.flatnonzero(np.abs(gr - wr) > 1e-3 * np.abs(w).max())
            assert off.size == 0 or off[-1] - off[0] < 512, (row, off.size, off[0], off[-1])
        assert got.item() > 0.1
    if L == 24000:
        assert not g[:, 16000:].any()


# --- the perceptual train step -----------------------------------------------------


def _cfgs(model, perceptual, accum=1):
    common = dict(model=model, loss="MSE" if model == "CRN" else "SDR", perceptual=perceptual,
                  lstm="real" if model == "CRN" else "complex")
    return (
        JConfig(**common, dccrn=JDccrnConfig(kernel_num=TINY_KN, rnn_units=32),
                crn=JCrnConfig(**TINY_CRN), use_pallas_lstm="on",
                train=JTrainConfig(learning_rate=LR, grad_accum=accum)),
        Config(**common, dccrn=DccrnConfig(kernel_num=TINY_KN, rnn_units=32),
               crn=CrnConfig(**TINY_CRN), train=TrainConfig(learning_rate=LR, grad_accum=accum)),
    )


@pytest.fixture(scope="module")
def tiny():
    """Two 0.5-s utterances (PMSQE scores a sub-second utterance whole) and
    each model's tree."""
    rng = np.random.default_rng(3)
    clean = _speech(2, 8000, rng)
    noisy = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    trees = {m: (random_crn_params if m == "CRN" else random_dccrn_params)(
        _cfgs(m, "LMS")[1], seed=0) for m in ("DCCRN", "CRN")}
    return types.SimpleNamespace(noisy=noisy, clean=clean, trees=trees)


def _sd(cfg, params, bstats):
    to_np = lambda t: jax.tree.map(np.array, t)
    return {k: v.numpy() for k, v in state_dict_from_jax(to_np(params), to_np(bstats),
                                                         cfg).items()}


def _cancelled_by_batch_norm(model):
    """The conv biases that feed a train-mode BatchNorm: their exact
    gradient is 0, and both packages give roundoff there."""
    sd = model.state_dict()
    return {k for k in sd if k.endswith("conv.bias")
            and k.rsplit(".", 3)[0] + ".1.running_mean" in sd}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("perceptual", ["LMS", "PMSQE"])
@pytest.mark.parametrize("model", ["DCCRN", "CRN"])
def test_perceptual_train_step_matches_jax(tiny, model, perceptual, accum):
    """``loss``, ``main_loss`` and ``perceptual_loss`` at rtol 1e-4 (each the
    mean over the micro-batches); every gradient leaf, read back from JAX's
    Adam moment (``(1 - b1) g`` after the first step), within 1e-3 (CRN with
    LMS: 1e-2) of max(its largest, 1e-2 x the model's largest), but the
    BatchNorm-cancelled conv biases, both below 1e-5 of the largest
    gradient (see the module's docstring); the running statistics at atol
    1e-5, rtol 1e-4; ``eval_step`` reports the two terms too."""
    jcfg, cfg = _cfgs(model, perceptual, accum)
    params, bstats = tiny.trees[model]
    tx = jmake_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=0, params=jp, batch_stats=jax.tree.map(jnp.asarray, bstats),
                       opt_state=tx.init(jp), tx=tx)
    state, metrics = make_train_step(jcfg, jbuild_model(jcfg))(
        state, jnp.asarray(tiny.noisy), jnp.asarray(tiny.clean), jax.random.PRNGKey(0))
    want = _sd(cfg, jax.tree.map(lambda m: np.asarray(m, np.float64) / (1 - B1),
                                 state.opt_state[0].mu), bstats)
    want_stats = _sd(cfg, params, state.batch_stats)

    m, opt = create_train_state(cfg, state_dict_from_jax(params, bstats, cfg), device="cpu")
    got_m = train_step(cfg, m, opt, tiny.noisy, tiny.clean)
    assert set(got_m) == {"loss", "main_loss", "perceptual_loss"}
    for k, v in got_m.items():
        np.testing.assert_allclose(v.item(), float(metrics[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got_m["loss"].item(),
                               (got_m["main_loss"] + got_m["perceptual_loss"]).item() / 2,
                               rtol=1e-6)
    cancelled = _cancelled_by_batch_norm(m)
    scale = max(np.abs(w).max() for w in want.values())
    tol = 1e-2 if (model, perceptual) == ("CRN", "LMS") else 1e-3
    for k, p in m.named_parameters():
        g, w = p.grad.numpy(), want[k]
        if k in cancelled:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-5 * scale, k
        else:
            err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-2 * scale)
            assert err <= tol, (k, err)
    for k, v in m.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want_stats[k], atol=1e-5, rtol=1e-4, err_msg=k)

    metrics_e, wav = eval_step(cfg, m, tiny.noisy, tiny.clean)
    assert set(metrics_e) == {"loss", "main_loss", "perceptual_loss"}
    assert wav.shape == tiny.noisy.shape


# --- the train CLI -------------------------------------------------------------------


def _fake_scores(est, clean):
    return [1.5] * len(est), [0.5] * len(est)


def _masked(text):
    """A log entry with its numbers replaced, for comparing formats."""
    return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", text)


def test_cli_writes_the_jax_log_entry_for_a_perceptual_run(tmp_path):
    """One epoch of ``python -m se_tpu_torch.train_interface --device cpu
    --perceptual PMSQE`` (CRN at full width, two 1-s utterances, the numpy
    PESQ and STOI): ``log.txt``'s epoch entry has the JAX loop's three lines
    (the losses, the main and perceptual losses, the scores), the format the
    JAX Trainer writes for a tiny perceptual CRN, its numbers those of the
    run."""
    rng = np.random.default_rng(4)
    clean = _speech(2, 16000, rng)
    noisy = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    data = np.stack([noisy, clean], 1)
    path = str(tmp_path / "data.npy")
    np.save(path, data)
    trainer = train_interface.main([
        "--device", "cpu", "--model", "CRN", "--lstm", "real", "--loss", "MSE",
        "--perceptual", "PMSQE", "--train-data", path, "--valid-data", path, "--batch", "2",
        "--max-epochs", "1", "--job-dir", str(tmp_path / "models"), "--logs-dir",
        str(tmp_path / "logs")])
    log = open(os.path.join(trainer.dir_to_save, "log.txt")).read()
    entry = log[log.index("Epoch [1]"):]

    jcfg, _ = _cfgs("CRN", "PMSQE")
    jcfg = jcfg.replace(train=JTrainConfig(max_epochs=1, batch=2, learning_rate=LR,
                                           job_dir=str(tmp_path / "jax"),
                                           logs_dir=str(tmp_path / "jax_logs")))

    def random_state(c):
        p, b = (jax.tree.map(jnp.asarray, t) for t in random_crn_params(_cfgs("CRN", "PMSQE")[1]))
        tx = jmake_optimizer(c)
        return jbuild_model(c), TrainState(step=0, params=p, batch_stats=b,
                                           opt_state=tx.init(p), tx=tx)

    tiny_data = data[:, :, :8000]
    jt = jloop.Trainer(jcfg, tiny_data, tiny_data, score_fn=_fake_scores)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "create_train_state", random_state)
        jt.setup()
    jt.run()
    jlog = open(os.path.join(jt.dir_to_save, "log.txt")).read()
    jentry = jlog[jlog.index("Epoch [1]"):]
    assert _masked(entry) == _masked(jentry)
    assert len(entry.splitlines()) == 3

    h = trainer.history[0]
    t, v = re.match(r"Epoch \[1\] \| T (\S+) \| V (\S+)\n", entry).groups()
    assert float(t) == float(f"{h['train_loss']:.6f}") and float(v) == float(f"{h['valid_loss']:.6}")
    tm, tp, vm, vp = map(float, re.search(
        r"\n {10}\| T (\S+) (\S+) \| V (\S+) (\S+) takes", entry).groups())
    assert abs((tm + tp) / 2 - h["train_loss"]) <= 1e-5 * max(1.0, abs(h["train_loss"]))
    assert abs((vm + vp) / 2 - h["valid_loss"]) <= 1e-5 * max(1.0, abs(h["valid_loss"]))
    assert tp > 0 and vp > 0


@pytest.mark.parametrize("flags", [
    ["--perceptual", "LMS"], ["--perceptual", "PMSQE"], ["--masking-mode", "Direct(None make)"],
    ["--no-skip"], ["--use-cbn"], ["--no-skip", "--use-cbn", "--model", "CRN"],
], ids=["lms", "pmsqe", "dccrn-direct", "no-skip", "use-cbn", "crn-no-skip"])
def test_reject_unported_raises_only_for_mesh(flags):
    """Every trainer variant and model switch parses; with ``--mesh`` only a
    batch its ranks cannot split raises, in JAX's words (a group of one,
    3 rows in 2 micro-batches)."""
    base = ["--train-data", "x.npy", "--valid-data", "x.npy"]
    _, args = train_interface.parse_args(base + flags)
    assert not args.mesh
    with pytest.raises(ValueError, match="grad_accum x mesh devices"):
        train_interface.main(base + flags + ["--mesh", "--batch", "3", "--grad-accum", "2",
                                             "--device", "cpu"])
