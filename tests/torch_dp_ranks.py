"""What each rank of ``tests/test_torch_parallel_2proc.py`` runs.

The ranks are processes spawned by ``se_tpu_torch.parallel.launch.spawn``;
they import this module, torch and the port, and not JAX, so that they
start in seconds.  The parent runs the same functions without a group for
the port's one-process step.
"""

import numpy as np
import torch

from se_tpu_torch.data.dataset import WaveDataset
from se_tpu_torch.data.multihost import MultiHostLoader
from se_tpu_torch.parallel.dp import parallel_train_step
from se_tpu_torch.parallel.mesh import make_mesh
from se_tpu_torch.train.loop import Trainer
from se_tpu_torch.train.state import create_train_state
from se_tpu_torch.train.steps import train_step

RUNNING = ("running_mean", "running_var", "RMr", "RMi", "RVrr", "RVri", "RVii")


def fake_scores(est, clean):
    """Stand-ins for PESQ and STOI: each row's mean |clean| (an input, the
    same bits in both packages, so the rows' order shows) and mean |est|."""
    return ([float(np.mean(np.abs(c))) for c in clean],
            [float(np.mean(np.abs(e))) for e in est])


def train_readings(cfg, state_dict, noisy, clean, steps: int, mesh=None) -> dict:
    """``steps`` train steps of the global batch ``(noisy, clean)`` from
    ``state_dict``: on this rank's rows under ``mesh``, else on all of them
    in one process -> ``losses`` (each step's), ``grads`` and ``stats``
    (the gradients and the running statistics of the first step) and
    ``final`` (every floating leaf of the state dict, and Adam's moments as
    ``<param>.exp_avg`` and ``<param>.exp_avg_sq``, after the last)."""
    torch.manual_seed(0)
    model, opt = create_train_state(cfg, state_dict, device="cpu")
    if mesh is not None:
        loader = MultiHostLoader(WaveDataset(np.stack([noisy, clean], 1)), len(noisy),
                                 mesh.rank, mesh.world, shuffle=False,
                                 grad_accum=cfg.train.grad_accum)
        noisy, clean = next(iter(loader))
    out = dict(losses=[])
    for s in range(steps):
        if mesh is None:
            metrics = train_step(cfg, model, opt, noisy, clean)
        else:
            metrics = parallel_train_step(cfg, model, opt, mesh, noisy, clean)
        out["losses"].append(metrics["loss"].item())
        if s == 0:
            out["grads"] = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
            out["stats"] = {k: v.numpy().copy() for k, v in model.state_dict().items()
                            if k.endswith(RUNNING)}
    final = {k: v.numpy().copy() for k, v in model.state_dict().items()
             if v.is_floating_point()}
    for i, (k, _) in enumerate(model.named_parameters()):
        for name in ("exp_avg", "exp_avg_sq"):
            final[f"{k}.{name}"] = opt.state_dict()["state"][i][name].numpy().copy()
    out["final"] = final
    return out


def trainer_run(cfg, state_dict, train, valid) -> dict:
    """A ``Trainer(use_mesh=True)`` run from ``state_dict`` with
    :func:`fake_scores` -> its ``mse_vali_total``, run directory and each
    epoch's train loss."""
    t = Trainer(cfg, train, valid, score_fn=fake_scores, device="cpu", use_mesh=True)
    t.setup()
    t.model.load_state_dict(state_dict, strict=True)
    mse = t.run()
    return dict(mse=mse, dir=t.dir_to_save, train_losses=[h["train_loss"] for h in t.history])


def run_jobs(jobs: dict) -> dict:
    """Each rank's entry: ``{name: (function name, args)}`` run in turn in
    one group -> ``{name: result}``."""
    torch.set_num_threads(1)
    mesh = make_mesh("cpu")
    out = {}
    for name, (fn, args) in jobs.items():
        if fn == "train_readings":
            out[name] = train_readings(*args, mesh=mesh)
        else:
            out[name] = trainer_run(*args)
    out["rank"] = mesh.rank
    return out
