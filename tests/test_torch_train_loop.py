"""The PyTorch port's training loop (se_tpu_torch.train.loop) and train CLI
against the JAX package's on the CPU at a tiny width: two epochs of both
Trainers from the same weights and data, the run directory's artifacts and
their formats, resume (bit-exact on the CPU), the CLI at full width, and
its flags.

The JAX side runs with ``use_pallas_lstm="auto"`` (the scan LSTM on the
CPU), its ``setup()`` given a state of ``random_dccrn_params`` in place of
flax's init; the port's starts from ``state_dict_from_jax`` of the same
tree."""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from se_tpu.config import (
    Config as JConfig,
    DccrnConfig as JDccrnConfig,
    TrainConfig as JTrainConfig,
)
from se_tpu.models import build_model as jbuild_model
from se_tpu.train import loop as jloop
from se_tpu.train.loop import Trainer as JTrainer
from se_tpu.train.state import TrainState, make_optimizer as jmake_optimizer

from se_tpu_torch import train_interface
from se_tpu_torch.config import Config, DccrnConfig, TrainConfig
from se_tpu_torch.train.checkpoint import copy_best_checkpoint
from se_tpu_torch.train.loop import Trainer
from se_tpu_torch.train.steps import eval_step
from se_tpu_torch.utils.weights import dccrn_state_dict_from_jax, random_dccrn_params

TINY = dict(kernel_num=(8, 16, 16), rnn_units=32)
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run gives each of its workers a share of the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(n, seed, L=4000):
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((n, L)) * 0.1).astype(np.float32)
    noisy = (clean + rng.standard_normal((n, L)) * 0.05).astype(np.float32)
    return np.stack([noisy, clean], 1)


TRAIN, VALID = _corpus(4, 0), _corpus(3, 1)  # valid: batches of 2 and 1


def _fake_scores(est, clean):
    """Deterministic stand-ins for PESQ and STOI that read the estimate."""
    return ([float(np.mean(np.abs(e))) for e in est],
            [float(np.mean(np.asarray(e, np.float64) * c)) for e, c in zip(est, clean)])


def _train_cfg(job, epochs=2, **kw):
    return TrainConfig(max_epochs=epochs, batch=2, learning_rate=LR, job_dir=str(job / "models"),
                       logs_dir=str(job / "logs"), **kw)


def _port_trainer(job, params, bstats, epochs=2, data=TRAIN, **kw):
    cfg = Config(dccrn=DccrnConfig(**TINY), train=_train_cfg(job, epochs, **kw))
    t = Trainer(cfg, data, VALID, score_fn=_fake_scores, device="cpu")
    t.setup()
    if t.epoch_start_idx == 1:
        t.model.load_state_dict(dccrn_state_dict_from_jax(params, bstats, cfg), strict=True)
    return t


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two epochs of the JAX Trainer and of the port's, same weights and data;
    each epoch's train and validation losses recorded."""
    cfg = Config(dccrn=DccrnConfig(**TINY))
    params, bstats = random_dccrn_params(cfg, seed=0)

    def random_state(jcfg):
        """The JAX Trainer's model and state, its weights drawn by
        ``random_dccrn_params`` instead of flax's init."""
        tx = jmake_optimizer(jcfg)
        p, b = (jax.tree.map(jnp.asarray, t) for t in (params, bstats))
        return jbuild_model(jcfg), TrainState(step=0, params=p, batch_stats=b,
                                              opt_state=tx.init(p), tx=tx)

    jdir = tmp_path_factory.mktemp("jax")
    jcfg = JConfig(dccrn=JDccrnConfig(**TINY), train=_train_cfg(jdir))
    jt = JTrainer(jcfg, TRAIN, VALID, score_fn=_fake_scores)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "create_train_state", random_state)
        jt.setup()
    jlosses = []
    train_epoch, validate_epoch = jt.train_epoch, jt.validate_epoch
    jt.train_epoch = lambda: jlosses.append(train_epoch()) or jlosses[-1]
    jt.validate_epoch = lambda e: jlosses.append(validate_epoch(e)) or jlosses[-1]
    jmse = jt.run()
    jfinal = dccrn_state_dict_from_jax(jax.tree.map(np.array, jt.state.params),
                                       jax.tree.map(np.array, jt.state.batch_stats), cfg)

    pt = _port_trainer(tmp_path_factory.mktemp("port"), params, bstats)
    pmse = pt.run()
    return dict(jax=jt, jlosses=jlosses, jmse=jmse, jfinal=jfinal, port=pt, pmse=pmse,
                params=params, bstats=bstats)


def test_loop_matches_jax_over_two_epochs(runs):
    """Two epochs of both loops from the same weights and batches.

    Each epoch's train loss (the mean of two steps) at rtol 1e-4, as
    ``tests/test_torch_train.py`` holds one step.  Every parameter and
    running statistic after four Adam steps within 2e-5, but the conv biases
    that feed a BatchNorm and those BatchNorms' running means, which are held
    to the most two four-step Adam runs can differ by.  A train-mode BatchNorm
    cancels such a bias, so its gradient is roundoff in both packages; Adam
    turns roundoff into a step of about lr x its sign, which differs between
    them, and the running mean takes the moved bias in.  Train losses do not
    see this (the bias cancels); eval mode does, through bias minus running
    mean: so the validation losses and ``mse_vali_total`` are held at rtol
    2e-2 (measured 6.5e-3 after epoch 1), and the port's ``eval_step`` on
    the JAX loop's final state to the JAX loop's last validation loss at
    rtol 1e-4."""
    pt = runs["port"]
    jtr, jva = runs["jlosses"][0::2], runs["jlosses"][1::2]
    for h, tr, va in zip(pt.history, jtr, jva, strict=True):
        np.testing.assert_allclose(h["train_loss"], tr["loss"], rtol=1e-4)
        np.testing.assert_allclose(h["valid_loss"], va["loss"], rtol=2e-2)
    np.testing.assert_allclose(runs["pmse"], runs["jmse"], rtol=2e-2)

    sd = pt.model.state_dict()
    want = {k: v.numpy() for k, v in runs["jfinal"].items()}
    assert sd.keys() == want.keys()
    cancelled = {k for k in sd if k.endswith("_conv.bias")
                 and k.rsplit(".", 3)[0] + ".1.running_mean" in sd}
    followers = {k.rsplit(".", 3)[0] + ".1.running_mean" for k in cancelled}
    assert len(cancelled) == 10 and len(followers) == 5
    deltas = {k: np.abs(v.numpy().astype(np.float64) - want[k]).ravel() for k, v in sd.items()
              if v.is_floating_point()}
    # Adam's step t moves an entry by at most about lr x sqrt(t)
    spread = 2 * LR * sum(np.sqrt(t) for t in range(1, 5))
    assert max(deltas[k].max() for k in cancelled | followers) <= spread  # measured 6.0e-3
    rest = max(d.max() for k, d in deltas.items() if k not in cancelled | followers)
    assert rest <= 2e-5, rest  # measured 8.7e-6

    model = pt.model
    model.load_state_dict(runs["jfinal"], strict=True)
    total = sum(eval_step(pt.cfg, model, VALID[i : i + 2, 0], VALID[i : i + 2, 1])[0]["loss"].item()
                * len(VALID[i : i + 2]) for i in (0, 2))
    np.testing.assert_allclose(total / len(VALID), jva[-1]["loss"], rtol=1e-4)


_NUMBER = r"-?\d+(?:\.\d+)?(?:e[-+]\d+)?"
# Each line of Epoch_N_SCORES and of log.txt after its date: its text with
# {} for each number, and the format each number is written with
# (se_tpu/train/loop.py and se_tpu_torch/train/loop.py alike)
_LINE_FORMATS = (
    ("PESQ {} | STOI {}", (".6f", ".6f")),
    ("total params   : {} ({} M, {} MBytes)", ("d", ".2f", ".2f")),
    ("Epoch [{}] | T {} | V {} takes {} seconds", ("d", ".6f", ".6", ".2f")),
    ("          | V PESQ: {} | STOI: {} ", (".6f", ".6f")),
)


def _check_format(line):
    """Assert that ``line`` is one of ``_LINE_FORMATS`` and that each of its
    numbers is what its field's format writes (re-formats to itself: the
    general ``.6`` drops trailing zeros, ``.6f`` keeps six decimals);
    return its text with {} for the numbers."""
    text = re.sub(_NUMBER, "{}", line)
    fmts = dict(_LINE_FORMATS).get(text)
    assert fmts is not None, f"unexpected line {line!r}"
    numbers = re.findall(_NUMBER, line)
    for tok, fmt in zip(numbers, fmts):
        value = int(tok) if fmt == "d" else float(tok)
        assert format(value, fmt) == tok, (line, tok, fmt)
    return text


def test_run_directory_artifacts_and_formats_match_jax(runs, tmp_path):
    """The port's run directory holds the reference's artifacts; its
    ``Epoch_N_SCORES`` lines and epoch lines have the JAX loop's text, each
    number as its field's format writes it (and
    scores within 1e-4 of its, from the same fake scorer), and
    ``chkpt_opt.pt`` is the epoch of least validation loss."""
    pt, jt = runs["port"], runs["jax"]
    d = pt.dir_to_save
    assert sorted(os.listdir(d)) == ["Epoch_1_SCORES", "Epoch_2_SCORES", "chkpt_1.pt",
                                     "chkpt_2.pt", "chkpt_opt.pt", "log.txt",
                                     "mse_vali_total.npy"]
    assert os.path.isdir(pt.dir_to_logs)
    assert os.path.basename(d) == os.path.basename(jt.dir_to_save)
    for epoch in (1, 2):
        name = f"Epoch_{epoch}_SCORES"
        got = open(os.path.join(d, name)).read()
        want = open(os.path.join(jt.dir_to_save, name)).read()
        assert len(got.splitlines()) == len(VALID)
        for a, b in zip(got.splitlines(), want.splitlines()):
            assert _check_format(a) == _check_format(b), (a, b)
        g = np.array(re.findall(r"-?\d+\.\d+", got), float)
        np.testing.assert_allclose(g, np.array(re.findall(r"-?\d+\.\d+", want), float),
                                   atol=1e-4)
    log = open(os.path.join(d, "log.txt")).read().splitlines()
    jlog = open(os.path.join(jt.dir_to_save, "log.txt")).read().splitlines()
    assert len(log) == len(jlog) == 6
    assert log[1].startswith("total params   : ")
    for a, b in zip(log[1:], jlog[1:]):
        assert _check_format(a) == _check_format(b), (a, b)
    best = int(np.argmin(runs["pmse"])) + 1
    blob = torch.load(os.path.join(d, "chkpt_opt.pt"), weights_only=True)
    assert blob["epoch"] == best and set(blob) == {"model", "optimizer", "epoch"}


def test_best_copy_skips_epochs_never_validated(tmp_path):
    """Exact-0.0 entries of ``mse_vali_total`` are epochs never validated:
    the least of the others is copied (MSE-like losses, where 0.0 would
    otherwise win)."""
    for epoch in (1, 2, 3):
        torch.save({"epoch": epoch}, tmp_path / f"chkpt_{epoch}.pt")
    copy_best_checkpoint(str(tmp_path), np.array([0.5, 0.0, 0.3]))
    assert torch.load(tmp_path / "chkpt_opt.pt")["epoch"] == 3
    copy_best_checkpoint(str(tmp_path), np.array([0.0, 0.0, 0.0]))
    assert torch.load(tmp_path / "chkpt_opt.pt")["epoch"] == 1


class _Recording:
    """A dataset that records the rows the loader draws."""

    def __init__(self, data):
        self.rows, self.drawn = data, []

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        self.drawn.append(i)
        return self.rows[i, 0], self.rows[i, 1]


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_resume_is_exact_on_the_cpu(runs, tmp_path, mu_dtype):
    """One epoch, then a resume from ``chkpt_1.pt`` for epoch 2, equals two
    uninterrupted epochs bit for bit: every parameter and buffer, Adam's
    state (a bf16 first moment stays bf16 through ``weights_only``) and
    ``mse_vali_total``; epoch 2 draws the rows in the uninterrupted run's
    epoch-2 order, not epoch 1's again."""
    p, b = runs["params"], runs["bstats"]
    full_data, part_data = _Recording(TRAIN), _Recording(TRAIN)
    full = _port_trainer(tmp_path / "full", p, b, data=full_data, adam_mu_dtype=mu_dtype)
    full.run()
    part = _port_trainer(tmp_path / "part", p, b, epochs=1, data=part_data,
                         adam_mu_dtype=mu_dtype)
    part.run()
    name = os.path.basename(part.dir_to_save)
    resumed = _port_trainer(tmp_path / "part", p, b, data=part_data, adam_mu_dtype=mu_dtype,
                            chkpt_model=name, chkpt="1")
    assert resumed.epoch_start_idx == 2
    resumed.run()

    assert part_data.drawn == full_data.drawn and part_data.drawn[:4] != part_data.drawn[4:]
    a = torch.load(os.path.join(full.dir_to_save, "chkpt_2.pt"), weights_only=True)
    c = torch.load(os.path.join(resumed.dir_to_save, "chkpt_2.pt"), weights_only=True)
    assert a["epoch"] == c["epoch"] == 2
    assert a["model"].keys() == c["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], c["model"][k]), k
    sa, sc = a["optimizer"]["state"], c["optimizer"]["state"]
    assert sa.keys() == sc.keys() and a["optimizer"]["param_groups"] == c["optimizer"]["param_groups"]
    for i in sa:
        for k in sa[i]:
            x, y = sa[i][k], sc[i][k]
            assert (torch.equal(x, y) and x.dtype == y.dtype) if torch.is_tensor(x) else x == y
    if mu_dtype:
        assert {st["mu"].dtype for st in resumed.optimizer.state.values()} == {torch.bfloat16}
    np.testing.assert_array_equal(np.load(os.path.join(full.dir_to_save, "mse_vali_total.npy")),
                                  np.load(os.path.join(resumed.dir_to_save, "mse_vali_total.npy")))


def test_cli_trains_full_width_dccrn_on_the_cpu(tmp_path):
    """``main(["--device", "cpu", ...])``: one epoch of the default DCCRN at
    full width on two 1-s utterances, scored by the numpy PESQ and STOI
    (1 <= PESQ <= 4.64, 0 <= STOI <= 1)."""
    rng = np.random.default_rng(2)
    t = np.arange(16000) / 16000
    clean = np.stack([0.3 * np.sin(2 * np.pi * f * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
                      for f in (220, 330)]).astype(np.float32)
    noisy = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    path = str(tmp_path / "data.npy")
    np.save(path, np.stack([noisy, clean], 1))
    trainer = train_interface.main([
        "--device", "cpu", "--train-data", path, "--valid-data", path, "--batch", "2",
        "--max-epochs", "1", "--job-dir", str(tmp_path / "models"), "--logs-dir",
        str(tmp_path / "logs"), "--pallas-lstm", "on"])
    d = trainer.dir_to_save
    assert os.path.basename(d).endswith("_DCCRN_SDR")
    assert {"log.txt", "chkpt_1.pt", "chkpt_opt.pt", "mse_vali_total.npy",
            "Epoch_1_SCORES"} <= set(os.listdir(d))
    scores = np.array(re.findall(r"PESQ (\S+) \| STOI (\S+)",
                                 open(os.path.join(d, "Epoch_1_SCORES")).read()), float)
    assert scores.shape == (2, 2)
    assert np.all((scores[:, 0] >= 1.0) & (scores[:, 0] <= 4.64)), scores
    assert np.all((scores[:, 1] >= 0.0) & (scores[:, 1] <= 1.0)), scores
    assert np.isfinite(trainer.history[0]["train_loss"])


@pytest.mark.parametrize("flags, item", [
    (["--mesh", "--batch", "3", "--grad-accum", "2", "--device", "cpu"],
     "grad_accum x mesh devices"),
    (["--perceptual", "LMS"], None),
    (["--perceptual", "PMSQE"], None),
    (["--masking-mode", "Direct(None make)"], None),
    (["--no-skip"], None),
    (["--use-cbn"], None),
], ids=["mesh", "lms", "pmsqe", "dccrn-direct", "no-skip", "use-cbn"])
def test_unported_flags_raise_before_any_work(tmp_path, flags, item):
    """Every flag is ported: ``--mesh`` with a batch that its ranks cannot
    split raises ``ValueError`` in JAX's words before a model is built or a
    directory made (a group of one without torchrun); the trainer variants
    and model switches parse, and the Trainer takes a perceptual
    configuration."""
    argv = ["--train-data", "none.npy", "--valid-data", "none.npy", "--job-dir",
            str(tmp_path / "models"), *flags]
    if item is None:
        assert not train_interface.parse_args(argv)[1].mesh
    else:
        with pytest.raises(ValueError, match=item):
            train_interface.main(argv)
    cfg = Config(train=_train_cfg(tmp_path))
    Trainer(cfg.replace(perceptual="LMS"), TRAIN, VALID, device="cpu")
    assert os.listdir(tmp_path) == []


def test_crn_direct_masking_is_accepted():
    """CRN's direct mapping is ported (``crn_direct``): the CLI takes it."""
    _, args = train_interface.parse_args(["--model", "CRN", "--masking-mode", "Direct(None make)",
                                          "--train-data", "x", "--valid-data", "x"])
    assert (args.model, args.masking_mode) == ("CRN", "Direct(None make)")


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    """Without a card, the Trainer's default device and the CLI's raise (the
    CLI through its argument parser) before any directory is made."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a CUDA device")
    t = Trainer(Config(train=_train_cfg(tmp_path)), TRAIN, VALID)
    with pytest.raises(RuntimeError, match="cuda"):
        t.setup()
    with pytest.raises(SystemExit):
        train_interface.main(["--train-data", "x.npy", "--valid-data", "x.npy",
                              "--job-dir", str(tmp_path / "models")])
    assert os.listdir(tmp_path) == []


def test_resume_faults_tool_imports_no_jax_and_takes_its_faults_out():
    """``resume_faults.py`` (the repo root's fault planter for the card's
    resume check) imports nothing of JAX or the JAX package, as the port
    and ``chip_smoke.py`` do not (an AST scan), and a resume that fails
    leaves the loop's restore and the loader's ``set_epoch`` as they were."""
    import ast
    import importlib.util
    from pathlib import Path

    from se_tpu_torch.train import loop

    path = Path(__file__).resolve().parents[1] / "resume_faults.py"
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "flax", "optax", "orbax", "se_tpu", "tools"}, roots

    spec = importlib.util.spec_from_file_location("resume_faults", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    restore, set_epoch = loop.restore_checkpoint, loop.DataLoader.set_epoch
    for fault in tool.FAULTS:
        with pytest.raises(SystemExit):  # the CLI's parser: no --train-data
            tool.child(fault, ["--device", "cpu"])
        assert loop.restore_checkpoint is restore and loop.DataLoader.set_epoch is set_epoch
    with pytest.raises(ValueError, match="fault"):
        tool.child("none", ["--device", "cpu"])
