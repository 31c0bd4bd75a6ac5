"""The global view of a data-parallel step (counterpart of
``se_tpu/ops/rnn.py``'s ``shard_context``).

JAX's mesh step is one program over the global batch: its BatchNorm takes
the statistics of every row and its dropout draws one mask for the global
batch.  Here each rank of a ``torch.distributed`` group holds only its own
rows, so inside :func:`shard_context` the two do the same across the group:
the BatchNorms (``ops/norms.py``) all-reduce their sums with
:func:`all_reduce_sum`, through which the gradient flows, and the dropout
(``models/layers.py``) draws the global batch's mask and keeps this rank's
rows (:func:`local_rows`).  Outside the context, or in a process without a
group, every function here is the single-process one.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, NamedTuple, Optional

import torch
import torch.distributed as dist


class Shard(NamedTuple):
    """This process's place in the group: rank ``rank`` of ``world``, each
    rank holding the same number of consecutive rows of the global batch."""

    rank: int
    world: int


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("se_tpu_torch_shard", default=None)


@contextlib.contextmanager
def shard_context(rank: int, world: int) -> Iterator[None]:
    """Trace the enclosed forward passes as one slice of a global batch over
    the initialised default process group."""
    if not dist.is_initialized():
        raise RuntimeError("shard_context needs an initialised torch.distributed group")
    token = _ACTIVE.set(Shard(rank, world))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[Shard]:
    """The enclosing :func:`shard_context`'s shard, or None."""
    return _ACTIVE.get()


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group, whose gradient is the sum over the group of
    each rank's gradient of it: every rank's loss depends on every rank's
    input through the sum."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the group inside :func:`shard_context`, ``x``
    itself outside it; differentiable."""
    return x if active() is None else _AllReduceSum.apply(x)


def local_rows(shape, dim: int, draw):
    """``draw(shape)`` for the global batch, cut to this rank's rows:
    ``shape`` is the local one, with the batch on ``dim``.  Outside
    :func:`shard_context` it is ``draw(shape)``."""
    shard = active()
    if shard is None:
        return draw(tuple(shape))
    full = list(shape)
    full[dim] *= shard.world
    return draw(tuple(full)).narrow(dim, shard.rank * shape[dim], shape[dim])
