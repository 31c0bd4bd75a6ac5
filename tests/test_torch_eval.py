"""The PyTorch port's scoring and data loading against the JAX package's on
the CPU, and the round's PESQ/STOI receipt at a tiny width: a checkpoint
that the port's training loop writes, loaded by the JAX package, enhances
held-out utterances to the same scores in both packages (|dPESQ| <= 0.01
and |dSTOI| <= 0.01, the gate of docs/NORTH_STAR.md)."""

import numpy as np
import pytest
import torch
from scipy.signal import lfilter

import jax
import jax.numpy as jnp

from se_tpu.config import Config as JConfig, DccrnConfig as JDccrnConfig
from se_tpu.data import DataLoader as JDataLoader, MixingDataset as JMixingDataset
from se_tpu.data import WaveDataset as JWaveDataset
from se_tpu.eval import check_object_metrics as jcheck
from se_tpu.eval import metrics as jmetrics
from se_tpu.eval import pesq_native as jpesq_native
from se_tpu.eval.pesq_np import pesq_np as jpesq_np
from se_tpu.eval.stoi import stoi as jstoi
from se_tpu.models import build_model as jbuild_model
from se_tpu.train import state as jstate
from se_tpu.utils.torch_import import load_reference_checkpoint as jload_reference_checkpoint

from se_tpu_torch.config import Config, DccrnConfig, TrainConfig
from se_tpu_torch.data.dataset import DataLoader, MixingDataset, WaveDataset
from se_tpu_torch.enhance import enhance_batch
from se_tpu_torch.eval import metrics
from se_tpu_torch.eval.pesq_np import pesq_np
from se_tpu_torch.eval.stoi import stoi
from se_tpu_torch.train.loop import Trainer
from se_tpu_torch.utils.weights import random_dccrn_params

FS = 16000
TINY = dict(kernel_num=(8, 16, 16), rnn_units=32)
GATE = 0.01  # |dPESQ| and |dSTOI| per utterance, docs/NORTH_STAR.md


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run gives each of its workers a share of the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _speech(n, seconds, seed):
    """Voiced syllables ``[n, seconds * FS]`` float32: a gliding harmonic
    stack under a gated envelope (pauses between syllables), tilted to low
    frequencies as speech is."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * FS)) / FS
    out = []
    for _ in range(n):
        phase = 2 * np.pi * np.cumsum(rng.uniform(100, 250) * (1 + 0.1 * np.sin(2 * np.pi * t)))
        sig = sum(np.sin(k * phase / FS) / k for k in range(1, 30))
        env = np.maximum(0.0, np.sin(2 * np.pi * rng.uniform(2, 4) * t)) ** 0.5
        x = lfilter([1.0], [1.0, -0.9], env * sig)
        out.append(0.3 * x / np.abs(x).max())
    return np.stack(out).astype(np.float32)


def _at_snr(clean, snr_db, seed):
    """``clean`` plus low-pass noise at ``snr_db``."""
    noise = lfilter([1.0], [1.0, -0.95], np.random.default_rng(seed).standard_normal(clean.shape))
    scale = np.sqrt(np.mean(clean**2) / np.mean(noise**2) / 10 ** (snr_db / 10))
    return (clean + scale * noise).astype(np.float32)


def _pairs():
    """(clean, degraded) at 1, 1.5 and 2 s, each at 10 and 25 dB SNR."""
    pairs = []
    for i, seconds in enumerate((1.0, 1.5, 2.0)):
        clean = _speech(1, seconds, seed=i)[0]
        pairs += [(clean, _at_snr(clean, snr, seed=10 * i + snr)) for snr in (10, 25)]
    return pairs


PAIRS = _pairs()


def test_scorers_equal_the_jax_package_exactly():
    """The port's copies of the numpy P.862.2 and STOI give the JAX
    package's scores bit for bit on six pairs (three lengths, two SNRs), and
    so do ``cal_pesq``/``cal_stoi`` (serial and over a spawned pool of two)
    against the same scorers, ``cal_pesq`` being the native P.862.2 of both
    packages; PESQ lies in [1, 4.64] and falls with the SNR."""
    clean = [c for c, _ in PAIRS]
    deg = [d for _, d in PAIRS]
    want_p = [jpesq_np(c, d) for c, d in PAIRS]
    want_s = [jstoi(c, d, FS) for c, d in PAIRS]
    want_native = [jpesq_native.pesq(c, d) for c, d in PAIRS]
    assert [pesq_np(c, d) for c, d in PAIRS] == want_p
    assert [stoi(c, d, FS) for c, d in PAIRS] == want_s
    assert metrics.cal_pesq(deg, clean, FS) == want_native
    assert metrics.cal_stoi(deg, clean, FS) == want_s
    assert metrics.cal_pesq(deg, clean, FS, workers=2) == want_native
    assert metrics.cal_stoi(deg, clean, FS, workers=2) == want_s
    assert metrics._pool(2)._mp_context.get_start_method() == "spawn"
    # the JAX package's front end, on its numpy P.862 or its native build
    np.testing.assert_allclose(want_p, jmetrics.cal_pesq(deg, clean, FS), atol=1e-3)
    assert jmetrics.cal_stoi(deg, clean, FS) == want_s
    assert all(1.0 <= p <= 4.64 for p in want_p)
    assert all(a < b for a, b in zip(want_p[0::2], want_p[1::2])), want_p
    assert [metrics.cal_snr(d, c) for c, d in PAIRS] == [jmetrics.cal_snr(d, c) for c, d in PAIRS]


@pytest.mark.parametrize("seed", [0, 7])
def test_loaders_give_the_jax_loaders_batches(seed):
    """``DataLoader`` over a ``WaveDataset`` (train: shuffled, drop_last;
    valid: in order, a short last batch) and over a ``MixingDataset``: the
    JAX loaders' batches, bit for bit, for three epochs."""
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((7, 2, 64)).astype(np.float32)
    clean = [rng.standard_normal(64).astype(np.float32) for _ in range(5)]
    noises = [rng.standard_normal(n).astype(np.float32) for n in (50, 200)]
    pairs = [
        (DataLoader(WaveDataset(corpus), 3, shuffle=True, drop_last=True, seed=seed),
         JDataLoader(JWaveDataset(corpus), 3, shuffle=True, drop_last=True, seed=seed)),
        (DataLoader(WaveDataset(corpus, "valid"), 3), JDataLoader(JWaveDataset(corpus, "valid"), 3)),
        (DataLoader(MixingDataset(clean, noises, [-5, 0, 5], seed=seed), 2, shuffle=True,
                    seed=seed),
         JDataLoader(JMixingDataset(clean, noises, [-5, 0, 5], seed=seed), 2, shuffle=True,
                     seed=seed)),
    ]
    for ours, theirs in pairs:
        assert len(ours) == len(theirs)
        for _ in range(3):
            got, want = list(ours), list(theirs)
            assert len(got) == len(want)
            for (gn, gc), (wn, wc) in zip(got, want):
                np.testing.assert_array_equal(gn, wn)
                np.testing.assert_array_equal(gc, wc)


def test_port_checkpoint_scores_the_same_in_both_packages(tmp_path, monkeypatch):
    """The round's gate at a tiny width.  The port's Trainer trains DCCRN
    for one epoch on the CPU; the JAX package loads its ``chkpt_1.pt`` with
    ``load_reference_checkpoint``; both enhance three held-out 1.5-s
    utterances; the port's outputs are scored by the port's PESQ and STOI,
    the JAX package's by its own: |dPESQ| <= 0.01 and |dSTOI| <= 0.01 per
    utterance.  The JAX loader's template state is drawn by
    ``random_dccrn_params`` (the tree ``tests/test_torch_dccrn.py`` holds
    to flax's layout) instead of flax's init."""
    cfg = Config(dccrn=DccrnConfig(**TINY),
                 train=TrainConfig(max_epochs=1, batch=2, job_dir=str(tmp_path / "models"),
                                   logs_dir=str(tmp_path / "logs")))
    clean = _speech(4, 1.5, seed=20)
    train = np.stack([_at_snr(clean, 15, seed=21), clean], 1)
    trainer = Trainer(cfg, train, train[:2],
                      score_fn=lambda e, c: ([1.0] * len(e), [0.5] * len(e)), device="cpu")
    trainer.setup()
    trainer.run()
    ckpt = f"{trainer.dir_to_save}/chkpt_1.pt"

    jcfg = JConfig(dccrn=JDccrnConfig(**TINY))

    def template(jc):
        p, b = random_dccrn_params(cfg, seed=0)
        return None, jstate.TrainState(step=0, params=p, batch_stats=b, opt_state=(), tx=None)

    monkeypatch.setattr(jstate, "create_train_state", template)
    variables, epoch = jload_reference_checkpoint(ckpt, jcfg)
    assert epoch == 1

    held_clean = _speech(3, 1.5, seed=30)
    held_noisy = _at_snr(held_clean, 15, seed=31)
    want = np.asarray(jax.jit(lambda v, x: jbuild_model(jcfg).apply(v, x, train=False)[-1])(
        variables, jnp.asarray(held_noisy)))
    got = enhance_batch(trainer.model, held_noisy, device="cpu").numpy()
    assert got.shape == want.shape == held_noisy.shape
    assert np.abs(got - want).max() <= 1e-4

    p_port = metrics.cal_pesq(got, held_clean, FS)
    s_port = metrics.cal_stoi(got, held_clean, FS)
    p_jax = [jpesq_np(c, e) for c, e in zip(held_clean, want)]
    s_jax = [jstoi(c, e, FS) for c, e in zip(held_clean, want)]
    assert all(1.0 <= p <= 4.64 for p in p_port), p_port
    np.testing.assert_allclose(p_port, p_jax, atol=GATE)
    np.testing.assert_allclose(s_port, s_jax, atol=GATE)


def test_metric_checker_cli_scores_wav_files(tmp_path, capsys):
    """``check_object_metrics`` reads two wav files (int16, as written) and
    prints the PESQ, STOI and composite measures that the JAX package's
    checker gives on the same files, for one pair and for a directory of
    targets and estimates."""
    from se_tpu_torch.data.wav import read_wav, write_wav
    from se_tpu_torch.eval import check_object_metrics

    clean, deg = PAIRS[1]
    (tmp_path / "t").mkdir()
    (tmp_path / "e").mkdir()
    write_wav(str(tmp_path / "t" / "a_target.wav"), clean, FS)
    write_wav(str(tmp_path / "e" / "a_estimated.wav"), deg, FS)
    c, d = (read_wav(str(p))[0] for p in (tmp_path / "t" / "a_target.wav",
                                           tmp_path / "e" / "a_estimated.wav"))
    want = jcheck.check_pair(str(tmp_path / "t" / "a_target.wav"),
                             str(tmp_path / "e" / "a_estimated.wav"))
    assert want[:2] == (jpesq_native.pesq(c, d), jstoi(c, d, FS))
    capsys.readouterr()
    check_object_metrics.main([str(tmp_path / "t" / "a_target.wav"),
                               str(tmp_path / "e" / "a_estimated.wav")])
    assert (f"PESQ {want[0]:.4f} | STOI {want[1]:.4f} | CSIG {want[2]:.4f} | CBAK {want[3]:.4f} "
            f"| COVL {want[4]:.4f} | segSNR {want[5]:.4f}") in capsys.readouterr().out
    assert check_object_metrics.check_dirs(str(tmp_path / "t"), str(tmp_path / "e")) == [want]
