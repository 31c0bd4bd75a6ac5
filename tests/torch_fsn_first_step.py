"""FullSubNet's first Adam steps at full width, the PyTorch port against the
JAX package on the CPU, from the same weights and batch.

    JAX_PLATFORMS=cpu python tests/torch_fsn_first_step.py [dropout] [steps]

The default ``Config`` of each package with ``model="FullSubNet"``, MSE,
lr 1e-3, the given dropout (default 0) and the JAX side's scan LSTM (its
plain path on the CPU); weights from ``random_fullsubnet_params`` (seed 0)
through ``state_dict_from_jax``; one fixed batch of two 1-s utterances
(harmonic tones under a 3-Hz envelope plus white noise, numpy seed 12).
Prints each package's loss after each step (default 4) and their relative
difference.  With dropout above 0 the two packages draw different masks,
so their losses agree only in size.  Not collected by pytest: a JAX step
at full width takes several seconds to compile and run here.
``tests/test_torch_fsn_extras.py`` runs :func:`adam_losses` at a tiny
width.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from se_tpu.config import (  # noqa: E402
    Config as JConfig,
    FullSubNetConfig as JFullSubNetConfig,
    StftConfig as JStftConfig,
)
from se_tpu.models import build_model as jbuild_model  # noqa: E402
from se_tpu.train.state import TrainState, make_optimizer as jmake_optimizer  # noqa: E402
from se_tpu.train.steps import make_train_step  # noqa: E402

from se_tpu_torch.config import Config, FullSubNetConfig, StftConfig  # noqa: E402
from se_tpu_torch.train.state import create_train_state  # noqa: E402
from se_tpu_torch.train.steps import train_step  # noqa: E402
from se_tpu_torch.utils.weights import random_fullsubnet_params, state_dict_from_jax  # noqa: E402


def batch(B=2, L=16000, fs=16000, seed=12):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / fs
    clean = np.stack([0.3 * np.sin(2 * np.pi * rng.uniform(100, 250) * t)
                      * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) for _ in range(B)])
    clean = clean.astype(np.float32)
    noisy = (clean + rng.standard_normal(clean.shape) * 0.05).astype(np.float32)
    return noisy, clean


def adam_losses(noisy, clean, steps, stft=None, **fsn):
    """Both packages' train losses over ``steps`` Adam steps of FullSubNet
    (LSTM, MSE, lr 1e-3, ``FullSubNetConfig(**fsn)``, ``StftConfig(**stft)``)
    on one fixed batch from ``random_fullsubnet_params`` (seed 0) ->
    ``(port losses, JAX losses)``; JAX runs its jitted ``make_train_step``
    with the scan LSTM, its plain path on the CPU."""
    stft = stft or {}
    common = dict(model="FullSubNet", loss="MSE")
    cfg = Config(**common, stft=StftConfig(**stft), fullsubnet=FullSubNetConfig(**fsn))
    jcfg = JConfig(**common, stft=JStftConfig(**stft), fullsubnet=JFullSubNetConfig(**fsn),
                   use_pallas_lstm="off")
    params, bstats = random_fullsubnet_params(cfg, seed=0)

    tx = jmake_optimizer(jcfg)
    p = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=0, params=p, batch_stats=jax.tree.map(jnp.asarray, bstats),
                       opt_state=tx.init(p), tx=tx)
    step = make_train_step(jcfg, jbuild_model(jcfg))
    want = []
    for s in range(steps):
        state, metrics = step(state, jnp.asarray(noisy), jnp.asarray(clean), jax.random.PRNGKey(s))
        want.append(float(metrics["loss"]))

    model, opt = create_train_state(cfg, state_dict_from_jax(params, bstats, cfg), device="cpu")
    got = [train_step(cfg, model, opt, noisy, clean)["loss"].item() for _ in range(steps)]
    return got, want


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dropout = float(argv[0]) if argv else 0.0
    steps = int(argv[1]) if len(argv) > 1 else 4
    got, want = adam_losses(*batch(), steps, dropout=dropout)
    print(f"FullSubNet at full width, dropout {dropout}, B=2, 1 s, lr 1e-3")
    print("step  port loss        JAX loss         relative difference")
    for i, (a, b) in enumerate(zip(got, want), 1):
        print(f"{i:4d}  {a!r:<16} {b!r:<16} {abs(a - b) / abs(b):.3g}")


if __name__ == "__main__":
    main()
