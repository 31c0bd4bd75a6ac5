"""Data-parallel train and eval steps (counterpart of
``se_tpu/parallel/dp.py``).

JAX's mesh step is the single-device step over a batch sharded on the
``data`` axis: the same loss, gradients and BatchNorm statistics.  Here
every rank runs :func:`train.steps.accumulate_gradients` on its own rows
inside ``ops.shard.shard_context``, where the BatchNorms take the global
batch's statistics and the dropout the global batch's mask.  The summed
gradients are then all-reduced as one flat buffer and divided by ``world x
grad_accum``, so every rank takes the same Adam step.  A rank's rows are its
share of each of the ``grad_accum`` micro-batches, one after the other
(``data/multihost.py``), so its k-th micro-batch is its slice of the global
k-th.  The model is not wrapped in ``DistributedDataParallel``: the step
takes its gradients with ``torch.autograd.grad``, which DDP's reducer
hooks never see.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..config import Config
from ..ops.shard import shard_context
from ..train.steps import accumulate_gradients, eval_step
from .mesh import Mesh, all_reduce_


def _shard(mesh: Mesh):
    return shard_context(mesh.rank, mesh.world) if mesh.distributed else contextlib.nullcontext()


def _global_means(mesh: Mesh, metrics: dict, scale: float) -> dict:
    """Each metric summed over the group in one all-reduce, times ``scale``."""
    keys = list(metrics)
    flat = torch.stack([metrics[k].float() for k in keys])
    flat = all_reduce_(mesh, flat) * scale
    return dict(zip(keys, flat.unbind()))


def all_reduce_gradients(mesh: Mesh, grads, scale: float) -> list:
    """``grads`` summed over the group as one flat buffer per dtype, times
    ``scale`` -> new tensors of the same shapes (two parameters that shared
    one gradient tensor get their own)."""
    out = [None] * len(grads)
    for dtype in {g.dtype for g in grads}:
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        flat = all_reduce_(mesh, flat).mul_(scale)
        for i, piece in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = piece.view_as(grads[i])
    return out


def parallel_train_step(cfg: Config, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer, mesh: Mesh, inputs, targets,
                        generator: Optional[torch.Generator] = None) -> dict:
    """One optimisation step of the global batch from this rank's rows
    (``[B / world, L]`` each) -> the global metrics, as
    ``train.steps.train_step`` returns them for the whole batch."""
    accum = cfg.train.grad_accum
    with _shard(mesh):
        params, grads, sums = accumulate_gradients(cfg, model, inputs, targets, generator)
    scale = 1.0 / (mesh.world * accum)
    for p, g in zip(params, all_reduce_gradients(mesh, grads, scale)):
        p.grad = g
    optimizer.step()
    return _global_means(mesh, sums, scale)


def parallel_eval_step(cfg: Config, model: torch.nn.Module, mesh: Mesh, inputs, targets):
    """Validation of this rank's rows -> ``(global metrics, this rank's
    waveforms)``: the loss is the mean over the global batch, each rank's
    rows being as many."""
    metrics, outputs = eval_step(cfg, model, inputs, targets)
    return _global_means(mesh, metrics, 1.0 / mesh.world), outputs
