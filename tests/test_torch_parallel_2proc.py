"""Data-parallel training of the PyTorch port (se_tpu_torch.parallel) in two
gloo ranks on the CPU, against the JAX package's single-device step and its
``Trainer(use_mesh=True)`` over two devices, at a tiny width.

The two ranks are spawned once (``parallel.launch.spawn``, free ports) and
run every case in turn (``tests/torch_dp_ranks.py``, which imports no JAX),
while this process builds the JAX references.  A global batch of 8 rows,
4 a rank, 3 steps.  The JAX side runs its scan LSTM (``use_pallas_lstm=
"off"``), its plain reference on the CPU.

Tolerances.  Each step's loss at rtol 1e-4.  The first step's gradients by
``tests/test_torch_train.py``'s rule for a model's gradients: each leaf
within 1e-3 of its max, and a conv bias that feeds a train-mode BatchNorm,
whose exact gradient is 0, below 1e-5 of the model's largest gradient on
both sides.  (Elementwise atol 1e-5 with rtol 1e-4 does not hold even for
the one-process step against itself with its batch halves swapped:
1.86e-4 on ``encoder.0.0.real_conv.weight``, whose max is 0.854, is the
conv's reduction over rows in another order.)  The first step's running
statistics at atol 1e-5.  After the last step, the leaves a reduction order
moves by Adam steps (the BatchNorm-cancelled conv biases, their Adam
moments and their BatchNorms' running means) within ``2 lr sum_t sqrt(t)``
over the steps t run: Adam moves a parameter by at most lr sqrt(t) at step
t (``PERF.md`` section 2, the resume check's rule); every other leaf
(parameters, statistics, moments) within 2e-2 of its max, the resume
check's leaf limit: Adam turns roundoff-level gradients anywhere into steps
of about lr."""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from se_tpu.config import (
    Config as JConfig,
    CrnConfig as JCrnConfig,
    DccrnConfig as JDccrnConfig,
    FullSubNetConfig as JFullSubNetConfig,
    ParallelConfig as JParallelConfig,
    StftConfig as JStftConfig,
    TrainConfig as JTrainConfig,
)
from se_tpu.models import build_model as jbuild_model
from se_tpu.ops import norms as jnorms
from se_tpu.train import loop as jloop
from se_tpu.train.state import TrainState, make_optimizer as jmake_optimizer
from se_tpu.train.steps import train_step_body

from se_tpu_torch.config import (
    Config,
    CrnConfig,
    DccrnConfig,
    FullSubNetConfig,
    StftConfig,
    TrainConfig,
)
from se_tpu_torch.ops.norms import ComplexBnState
from se_tpu_torch.parallel.launch import spawn
from se_tpu_torch.utils.weights import (
    random_crn_params,
    random_dccrn_params,
    random_fullsubnet_params,
    state_dict_from_jax,
)
from tests.torch_dp_ranks import fake_scores, run_jobs, train_readings

LR = 1e-3
STEPS = 3
B, L = 8, 1600
TINY_KN = (8, 16, 16)
TINY_CRN = dict(rnn_input_size=256, rnn_units=32)
TINY_STFT = dict(fft_len=64, win_len=48)
TINY_FSN = dict(fb_model_hidden_size=32, sb_model_hidden_size=24, sb_num_neighbors=3)
LEAF_TOL = 2e-2
# a gradient leaf against JAX's: PERF.md section 2's rule for the card's
# step against the CPU's, 1e-3 of the larger of the leaf's max and 1e-2 of
# the model's largest gradient.  At 8 rows the port's one-process step
# itself is 1.65e-3 of its max from JAX's on DCCRN's smallest leaves (the
# LSTMs' and the projections', max ~5e-4 where the largest leaf is ~17).
JAX_FLOOR = 1e-2


def _cfgs(case: str, accum: int = 1, dropout: float = 0.0):
    """(JAX config, port config) of a case: ``dccrn``, ``dccrn-cbn``, ``crn``
    or ``fullsubnet``."""
    common = dict(model={"dccrn": "DCCRN", "dccrn-cbn": "DCCRN", "crn": "CRN",
                         "fullsubnet": "FullSubNet"}[case],
                  loss="SDR" if case.startswith("dccrn") else "MSE")
    jtrain = JTrainConfig(learning_rate=LR, grad_accum=accum)
    train = TrainConfig(learning_rate=LR, grad_accum=accum)
    if case == "fullsubnet":
        fsn = dict(TINY_FSN, dropout=dropout)
        return (JConfig(**common, stft=JStftConfig(**TINY_STFT),
                        fullsubnet=JFullSubNetConfig(**fsn), use_pallas_lstm="off", train=jtrain),
                Config(**common, stft=StftConfig(**TINY_STFT), fullsubnet=FullSubNetConfig(**fsn),
                       train=train))
    cbn = case == "dccrn-cbn"
    return (JConfig(**common, dccrn=JDccrnConfig(kernel_num=TINY_KN, rnn_units=32, use_cbn=cbn),
                    crn=JCrnConfig(**TINY_CRN), use_pallas_lstm="off", train=jtrain),
            Config(**common, dccrn=DccrnConfig(kernel_num=TINY_KN, rnn_units=32, use_cbn=cbn),
                   crn=CrnConfig(**TINY_CRN), train=train))


def _trees(cfg):
    draw = {"DCCRN": random_dccrn_params, "CRN": random_crn_params,
            "FullSubNet": random_fullsubnet_params}[cfg.model]
    return draw(cfg, seed=0)


def _batch(n=B, seed=0):
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((n, L)) * 0.1).astype(np.float32)
    noisy = (clean + rng.standard_normal((n, L)) * 0.05).astype(np.float32)
    return noisy, clean


STEP_CASES = {f"{case}-a{accum}": (case, accum) for case in ("dccrn", "dccrn-cbn", "crn")
              for accum in (1, 2)}
STEP_CASES["fullsubnet-d0"] = ("fullsubnet", 1)
DROPOUT = 0.5


def _trainer_cfgs(job):
    """A tiny DCCRN's Trainer configs, global batch 4 over two devices."""
    kw = dict(max_epochs=2, batch=4, learning_rate=LR, job_dir=str(job / "models"),
              logs_dir=str(job / "logs"))
    jcfg = JConfig(dccrn=JDccrnConfig(kernel_num=TINY_KN, rnn_units=32), use_pallas_lstm="off",
                   parallel=JParallelConfig(num_devices=2), train=JTrainConfig(**kw))
    cfg = Config(dccrn=DccrnConfig(kernel_num=TINY_KN, rnn_units=32), train=TrainConfig(**kw))
    return jcfg, cfg


TRAIN_ROWS = np.stack(_batch(8, seed=1), 1)
VALID_ROWS = np.stack(_batch(5, seed=2), 1)  # batches of 4 and 1 (wrap-padded to 4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results, computed in the background while the tests
    build their references."""
    noisy, clean = _batch()
    jobs = {}
    for name, (case, accum) in STEP_CASES.items():
        _, cfg = _cfgs(case, accum)
        jobs[name] = ("train_readings", (cfg, state_dict_from_jax(*_trees(cfg), cfg), noisy,
                                         clean, STEPS))
    _, cfg = _cfgs("fullsubnet", 1, DROPOUT)
    jobs["fullsubnet-dropout"] = ("train_readings", (cfg, state_dict_from_jax(*_trees(cfg), cfg),
                                                     noisy, clean, STEPS))
    job = tmp_path_factory.mktemp("port")
    _, cfg = _trainer_cfgs(job)
    jobs["trainer"] = ("trainer_run", (cfg, state_dict_from_jax(*_trees(cfg), cfg), TRAIN_ROWS,
                                       VALID_ROWS))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    with pytest.MonkeyPatch.context() as mp:
        # one BLAS thread a rank: two ranks' OpenBLAS pools spinning on the
        # same cores took 2.4 s for the conv-STFT's pseudo-inverse
        mp.setenv("OPENBLAS_NUM_THREADS", "1")
        future = pool.submit(spawn, run_jobs, 2, (jobs,), 600.0)
        yield future
        pool.shutdown(wait=True)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _jax_tree(tree):
    """A tree of ``random_*_params`` as JAX arrays, the complex BatchNorm's
    state in the JAX package's ``ComplexBnState``."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, ComplexBnState):
        return jnorms.ComplexBnState(*map(jnp.asarray, tree))
    return jnp.asarray(tree)


def _jax_steps(jcfg, cfg, noisy, clean) -> dict:
    """JAX's ``make_train_step`` body for STEPS steps, in ``train_readings``'s
    layout; the first step's gradients are its Adam first moment over 1 - b1
    (optax's mu after one step is (1 - b1) g)."""
    params, bstats = _trees(cfg)
    jmodel = jbuild_model(jcfg)
    tx = jmake_optimizer(jcfg)
    p, b = _jax_tree(params), _jax_tree(bstats)
    state = TrainState(step=0, params=p, batch_stats=b, opt_state=tx.init(p), tx=tx)
    noisy, clean = jnp.asarray(noisy), jnp.asarray(clean)
    # make_train_step's body, compiled without XLA's backend optimisations
    # (a fifth of the default's compile time here)
    step = jax.jit(train_step_body(jcfg, jmodel)).lower(
        state, noisy, clean, jax.random.PRNGKey(0)).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    out = dict(losses=[])
    for s in range(STEPS):
        state, metrics = step(state, noisy, clean, jax.random.PRNGKey(s))
        out["losses"].append(float(metrics["loss"]))
        adam = state.opt_state[0]
        if s == 0:
            # the gradients under the parameters' names, the statistics under theirs
            grads = jax.tree.map(lambda m: np.array(m) / np.float32(1 - 0.9), adam.mu)
            out["grads"] = out["stats"] = {k: v.numpy() for k, v in state_dict_from_jax(
                grads, _np(state.batch_stats), cfg).items()}
    final = {k: v.numpy() for k, v in state_dict_from_jax(
        _np(state.params), _np(state.batch_stats), cfg).items()}
    for name, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        moments = state_dict_from_jax(_np(tree), _np(state.batch_stats), cfg)
        final.update({f"{k}.{name}": v.numpy() for k, v in moments.items()})
    out["final"] = final
    return out


def _cancelled(names) -> set:
    """The conv biases that feed a train-mode BatchNorm (real or complex)."""
    names = set(names)
    return {k for k in names if k.endswith("conv.bias")
            and {k.rsplit(".", 3)[0] + ".1.running_mean", k.rsplit(".", 3)[0] + ".1.RMr"} & names}


def adam_bound(steps: int) -> float:
    return 2 * LR * sum(t**0.5 for t in range(1, steps + 1))


def _hold(got: dict, want: dict, floor: float = 0.0, steps: int = STEPS):
    """``train_readings`` of two runs, by the rules of the module docstring;
    a gradient leaf is held to 1e-3 of the larger of its max and ``floor``
    times the model's largest gradient."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    names = got["grads"].keys()
    cancelled = _cancelled(got["final"])
    scale = max(np.abs(want["grads"][k]).max() for k in names)
    for k in names:
        g, w = got["grads"][k], want["grads"][k]
        if k in cancelled:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-5 * scale, k
        else:
            err = np.abs(g - w).max()
            assert err <= 1e-3 * max(np.abs(w).max(), floor * scale), (k, err, np.abs(w).max())
    for k, v in got["stats"].items():
        np.testing.assert_allclose(v, want["stats"][k], atol=1e-5, err_msg=k)
    bns = {k.rsplit(".", 3)[0] + ".1" for k in cancelled}
    apart = {k for k in got["final"] if k.split(".exp_avg")[0] in cancelled
             or (k.rsplit(".", 1)[0] in bns and k.endswith(("running_mean", "RMr", "RMi")))}
    for k, v in got["final"].items():
        err = np.abs(v - want["final"][k]).max()
        if k in apart:
            assert err <= adam_bound(steps), (k, err)
        else:
            assert err <= LEAF_TOL * max(np.abs(want["final"][k]).max(), 1e-30), (k, err)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_two_ranks_equal_the_single_device_step(ranks, name):
    """Two gloo ranks, each on its 4 rows (its share of each micro-batch),
    against JAX's single-device ``make_train_step`` on the global batch and
    against the port's one-process ``train_step``: DCCRN with BatchNorm and
    with the complex BatchNorm, and CRN, at grad_accum 1 and 2; FullSubNet
    at dropout 0.  Both ranks report the same global loss and hold the same
    state."""
    case, accum = STEP_CASES[name]
    jcfg, cfg = _cfgs(case, accum)
    noisy, clean = _batch()
    want = _jax_steps(jcfg, cfg, noisy, clean)
    one = train_readings(cfg, state_dict_from_jax(*_trees(cfg), cfg), noisy, clean, STEPS)
    got = ranks.result()
    r0, r1 = got[0][name], got[1][name]
    assert (got[0]["rank"], got[1]["rank"]) == (0, 1)
    assert r0["losses"] == r1["losses"]
    for k, v in r0["final"].items():
        np.testing.assert_array_equal(v, r1["final"][k], err_msg=k)
    _hold(r0, one)
    _hold(r0, want, floor=JAX_FLOOR)
    _hold(one, want, floor=JAX_FLOOR)


def test_two_ranks_draw_the_one_process_dropout(ranks):
    """FullSubNet at dropout 0.5: each rank draws the global micro-batch's
    masks from the shared generator and keeps its rows, so two ranks equal
    the port's one-process step from the same seed.  The masks do act: the
    first step's gradients move from dropout 0's by a tenth of a leaf's max
    or more."""
    _, cfg = _cfgs("fullsubnet", 1, DROPOUT)
    noisy, clean = _batch()
    one = train_readings(cfg, state_dict_from_jax(*_trees(cfg), cfg), noisy, clean, STEPS)
    r0 = ranks.result()[0]
    _hold(r0["fullsubnet-dropout"], one)
    drop, d0 = r0["fullsubnet-dropout"]["grads"], r0["fullsubnet-d0"]["grads"]
    moved = max(np.abs(drop[k] - d0[k]).max() / np.abs(d0[k]).max() for k in d0)
    assert moved > 0.1, moved


def _scores(path):
    return np.array([[float(v) for v in line.replace("PESQ", "").split("| STOI")]
                     for line in path.read_text().splitlines()])


def test_two_rank_trainer_equals_the_jax_mesh_trainer(ranks, tmp_path):
    """Two epochs of a tiny DCCRN: two ranks of the port's
    ``Trainer(use_mesh=True)`` against JAX's ``Trainer(use_mesh=True)`` on a
    two-device mesh, from the same weights and data (8 training rows, 2
    steps an epoch; 5 validation rows, the second batch wrap-padded).  Each
    epoch's train loss at rtol 1e-4; ``mse_vali_total`` at rtol 2e-2, as
    ``tests/test_torch_train_loop.py`` holds two epochs of the two loops
    (a cancelled bias moved by Adam shows in eval mode); ``chkpt_2.pt``
    against JAX's final state by the module's rules over 4 steps; each
    ``Epoch_N_SCORES`` the 5 real rows in JAX's order (the fake PESQ is a
    function of the clean row)."""
    jcfg, cfg = _trainer_cfgs(tmp_path)
    params, bstats = _trees(cfg)

    def random_state(c):
        tx = jmake_optimizer(c)
        p, b = (jax.tree.map(jnp.asarray, t) for t in (params, bstats))
        return jbuild_model(c), TrainState(step=0, params=p, batch_stats=b,
                                           opt_state=tx.init(p), tx=tx)

    jt = jloop.Trainer(jcfg, TRAIN_ROWS, VALID_ROWS, use_mesh=True, score_fn=fake_scores)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "create_train_state", random_state)
        jt.setup()
    jtrain = []
    train_epoch = jt.train_epoch
    jt.train_epoch = lambda: jtrain.append(train_epoch()) or jtrain[-1]
    jmse = jt.run()

    got = ranks.result()
    r0, r1 = got[0]["trainer"], got[1]["trainer"]
    np.testing.assert_array_equal(r0["mse"], r1["mse"])
    np.testing.assert_allclose(r0["train_losses"], [t["loss"] for t in jtrain], rtol=1e-4)
    np.testing.assert_allclose(r0["mse"], jmse, rtol=2e-2)

    from pathlib import Path

    run, jrun = Path(r0["dir"]), Path(jt.dir_to_save)
    blob = torch.load(run / "chkpt_2.pt", map_location="cpu", weights_only=True)
    assert blob["epoch"] == 2
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        _np(jt.state.params), _np(jt.state.batch_stats), cfg).items()}
    names = [k for k in blob["model"] if blob["model"][k].is_floating_point()]
    cancelled = _cancelled(names)
    apart = cancelled | {k.rsplit(".", 3)[0] + ".1.running_mean" for k in cancelled}
    for k in names:
        err = np.abs(blob["model"][k].numpy() - want[k]).max()
        limit = adam_bound(4) if k in apart else LEAF_TOL * np.abs(want[k]).max()
        assert err <= limit, (k, err, limit)
    for e in (1, 2):
        port, jax_ = _scores(run / f"Epoch_{e}_SCORES"), _scores(jrun / f"Epoch_{e}_SCORES")
        assert port.shape == jax_.shape == (5, 2)
        np.testing.assert_array_equal(port[:, 0], jax_[:, 0])
    assert {"log.txt", "chkpt_1.pt", "chkpt_2.pt", "chkpt_opt.pt", "mse_vali_total.npy"} <= {
        p.name for p in run.iterdir()}
