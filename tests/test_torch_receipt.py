"""The round's receipt at full width (docs/NORTH_STAR.md's gate): a
checkpoint that the PyTorch port trains scores the same in both packages.

For DCCRN, CRN and FullSubNet at their published widths, the port's
Trainer takes a few Adam steps on the CPU (one epoch of 3 steps at batch 2
on 1.5-s utterances)
and writes ``chkpt_1.pt`` in the reference's format; the JAX package loads
it with ``se_tpu.utils.torch_import.load_reference_checkpoint``; both enhance
21 held-out utterances synthesized here (lengths 24000, 32000 and 40000;
SNR 0, 5 and 10 dB; white, pink and amplitude-modulated noise), each
package's output scored by its own native P.862 and STOI: |dPESQ| <= 0.01
and |dSTOI| <= 0.01 per utterance.  The JAX loader's template tree comes
from ``random_*_params`` (the layout the port's tests hold to flax's)
instead of flax's init.

Each case takes minutes on the CPU, so each is marked ``slow`` and the
tier-1 run leaves them out:

    python -m pytest tests/test_torch_receipt.py -m slow -s
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from se_tpu.config import Config as JConfig
from se_tpu.dsp import frame_stft as jframe_stft
from se_tpu.eval import metrics as jmetrics
from se_tpu.models import build_model as jbuild_model
from se_tpu.train import state as jstate
from se_tpu.train.steps import fullsubnet_enhance as jfullsubnet_enhance
from se_tpu.utils.torch_import import load_reference_checkpoint as jload_reference_checkpoint

from se_tpu_torch.config import Config, TrainConfig
from se_tpu_torch.enhance import enhance_batch
from se_tpu_torch.eval import metrics
from se_tpu_torch.train.loop import Trainer
from se_tpu_torch.utils.weights import (
    random_crn_params,
    random_dccrn_params,
    random_fullsubnet_params,
)

FS = 16000
GATE = 0.01  # |dPESQ| and |dSTOI| per utterance, docs/NORTH_STAR.md
LENGTHS = (24000, 32000, 40000)
SNRS = (0.0, 5.0, 10.0)
NOISES = ("white", "pink", "am")
N_HELD_OUT = 21
# the published configurations: DCCRN's default, CRN's tutorial one,
# FullSubNet's default (LSTM)
MODELS = {
    "DCCRN": (dict(), random_dccrn_params),
    "CRN": (dict(model="CRN", loss="MSE", lstm="real", masking_mode="E"), random_crn_params),
    "FullSubNet": (dict(model="FullSubNet", loss="MSE"), random_fullsubnet_params),
}


def _speech(rng, n, f0):
    """Voiced speech-like audio: pitch harmonics under three formants, a
    syllabic envelope and pauses, peak 0.25."""
    t = np.arange(n) / FS
    x = np.zeros(n)
    for k in range(1, 30):
        f = k * f0
        if f > 7000:
            break
        formant = (np.exp(-(((f - 500) / 300) ** 2)) + 0.7 * np.exp(-(((f - 1500) / 400) ** 2))
                   + 0.4 * np.exp(-(((f - 2500) / 500) ** 2)))
        x += formant / k * np.sin(2 * np.pi * f * t + rng.uniform(0, 6))
    x *= np.clip(np.sin(2 * np.pi * 4 * t + rng.uniform(0, 6)), 0, None)
    x *= np.sin(2 * np.pi * 0.7 * t) > -0.3
    x += 0.003 * rng.standard_normal(n)
    return 0.25 * x / np.max(np.abs(x))


def _noise(rng, kind, n):
    if kind == "white":
        x = rng.standard_normal(n)
    elif kind == "pink":  # 1/f power
        spec = np.fft.rfft(rng.standard_normal(n))
        f = np.arange(len(spec), dtype=np.float64)
        f[0] = 1.0
        x = np.fft.irfft(spec / np.sqrt(f), n)
    else:  # amplitude-modulated white noise
        t = np.arange(n) / FS
        x = rng.standard_normal(n) * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * t))
    return 0.2 * x / np.max(np.abs(x))


def _utterances(n, seed):
    """``n`` (noisy, clean, length, SNR, noise) of varied pitch: length by
    i mod 3, SNR by i // 3 mod 3, noise kind by i // 9 mod 3."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L, snr, kind = LENGTHS[i % 3], SNRS[i // 3 % 3], NOISES[i // 9 % 3]
        clean = _speech(rng, L, 85 + 9 * i + rng.uniform(-3, 3))
        noise = _noise(rng, kind, L)
        alpha = np.sqrt(10.0 ** (-snr / 10) * np.mean(clean**2) / (np.mean(noise**2) + 1e-20))
        out.append(((clean + alpha * noise).astype(np.float32), clean.astype(np.float32), L,
                    snr, kind))
    return out


def _jax_enhance(jcfg, variables, noisy):
    model = jbuild_model(jcfg)
    if jcfg.model == "FullSubNet":
        s = jcfg.stft

        def run(wavs):
            nc = jframe_stft(wavs, s.fft_len, s.torch_hop, s.win_len)
            crm = model.apply(variables, jnp.abs(nc), train=False)
            return jfullsubnet_enhance(jcfg, crm, nc, wavs.shape[-1])
    else:

        def run(wavs):
            return model.apply(variables, wavs, train=False)[-1]

    return np.asarray(jax.jit(run)(jnp.asarray(noisy)))


@pytest.mark.parametrize("model", [pytest.param(m, marks=pytest.mark.slow) for m in MODELS])
def test_full_width_checkpoint_scores_the_same_in_both_packages(model, tmp_path, monkeypatch):
    """The port trains, the JAX package loads; per utterance |dPESQ| and
    |dSTOI| <= 0.01, every score live (PESQ in [1, 4.64], STOI finite)."""
    t0 = time.perf_counter()
    fields, random_params = MODELS[model]
    cfg = Config(**fields, train=TrainConfig(max_epochs=1, batch=2,
                                             job_dir=str(tmp_path / "models"),
                                             logs_dir=str(tmp_path / "logs")))
    # 6 training utterances cut to 1.5 s: 3 steps at batch 2
    rows = np.stack([np.stack([n[:24000], c[:24000]]) for n, c, *_ in _utterances(6, seed=100)])
    trainer = Trainer(cfg, rows, rows[:2],
                      score_fn=lambda e, c: ([1.0] * len(e), [0.5] * len(e)), device="cpu")
    trainer.setup()
    trainer.run()
    ckpt = f"{trainer.dir_to_save}/chkpt_1.pt"
    blob = torch.load(ckpt, weights_only=True)
    assert set(blob) == {"model", "optimizer", "epoch"} and blob["epoch"] == 1
    trained_s = time.perf_counter() - t0

    jcfg = JConfig(**fields)

    def template(jc):
        p, b = random_params(cfg, seed=0)
        return None, jstate.TrainState(step=0, params=p, batch_stats=b, opt_state=(), tx=None)

    monkeypatch.setattr(jstate, "create_train_state", template)
    variables, epoch = jload_reference_checkpoint(ckpt, jcfg)
    assert epoch == 1
    variables = {"params": variables["params"], "batch_stats": variables["batch_stats"]}

    held = _utterances(N_HELD_OUT, seed=200)
    d_pesq, d_stoi, d_wav, scores = [], [], [], []
    for L in LENGTHS:
        group = [u for u in held if u[2] == L]
        noisy = np.stack([u[0] for u in group])
        clean = np.stack([u[1] for u in group])
        got = enhance_batch(trainer.model, noisy, device="cpu").numpy()
        want = _jax_enhance(jcfg, variables, noisy)
        assert got.shape == want.shape == noisy.shape
        assert np.isfinite(got).all() and np.isfinite(want).all()
        p_port, s_port = metrics.cal_pesq(got, clean, FS), metrics.cal_stoi(got, clean, FS)
        p_jax, s_jax = jmetrics.cal_pesq(want, clean, FS), jmetrics.cal_stoi(want, clean, FS)
        assert all(1.0 <= p <= 4.64 for p in (*p_port, *p_jax)), (p_port, p_jax)
        assert np.isfinite(s_port).all() and np.isfinite(s_jax).all()
        d_pesq += list(np.abs(np.asarray(p_port) - np.asarray(p_jax)))
        d_stoi += list(np.abs(np.asarray(s_port) - np.asarray(s_jax)))
        d_wav.append(float(np.abs(got - want).max()))
        scores += list(zip(p_port, s_port))
    assert len(d_pesq) == N_HELD_OUT
    print(f"\n[receipt {model}] {N_HELD_OUT} utterances: max |dPESQ| {max(d_pesq):.3g}, max "
          f"|dSTOI| {max(d_stoi):.3g} (gate {GATE}); max |port - JAX| wav {max(d_wav):.3g}; "
          f"port PESQ {min(p for p, _ in scores):.4f}-{max(p for p, _ in scores):.4f}, STOI "
          f"{min(s for _, s in scores):.4f}-{max(s for _, s in scores):.4f}; training "
          f"{trained_s:.1f} s, wall time {time.perf_counter() - t0:.1f} s")
    assert max(d_pesq) <= GATE and max(d_stoi) <= GATE, (max(d_pesq), max(d_stoi))
