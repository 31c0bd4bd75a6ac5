"""The process group of a data-parallel run (counterpart of
``se_tpu/parallel/mesh.py``).

JAX's ``--mesh`` is one program over a 1-D ``data`` axis of devices: the
batch is sharded over it and the state replicated.  Here each device is a
process of a ``torch.distributed`` group, one card a rank.  Under
``torchrun`` (``python -m torch.distributed.run``) the group comes from its
environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``.  Without those variables a run is a group of one process,
the counterpart of JAX's mesh over one device, and no group is made.  The
backend follows the device: NCCL for ``cuda:LOCAL_RANK``, gloo for the CPU.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the run: rank ``rank`` of ``world`` ranks,
    ``local_rank`` of the ``local_world`` on its host, on ``device``.
    ``distributed`` says whether a ``torch.distributed`` group exists (a
    group of one made without torchrun's environment has none)."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    device: torch.device
    distributed: bool

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def banner(self) -> str:
        kind = (f"torch.distributed group ({dist.get_backend()})" if self.distributed
                else "a group of one process (no torchrun environment)")
        return (f"mesh: rank {self.rank} of {self.world} on {self.device}, {kind}; "
                f"axis '{AXIS}' over {self.world} device(s)")


def make_mesh(device="cuda", backend=None) -> Mesh:
    """This process's :class:`Mesh`.  An initialised default group is used
    as it is; else torchrun's environment makes one (``backend``: NCCL on
    the card, gloo on the CPU, unless given); else the run is a group of
    one.  ``device`` without an index becomes ``cuda:LOCAL_RANK``; an
    explicit one is kept (ranks that share one card)."""
    dev = torch.device(device)
    env = os.environ
    local_rank = int(env.get("LOCAL_RANK", 0))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized() and "WORLD_SIZE" in env:
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method="env://", rank=int(env["RANK"]),
                                world_size=int(env["WORLD_SIZE"]))
    if not dist.is_initialized():
        return Mesh(0, 1, 0, 1, dev, False)
    world = dist.get_world_size()
    return Mesh(dist.get_rank(), world, local_rank, int(env.get("LOCAL_WORLD_SIZE", world)),
                dev, True)


def check_batch(batch: int, grad_accum: int, world: int) -> None:
    """Raise unless each of the ``grad_accum`` micro-batches of ``batch``
    rows splits evenly over the ``world`` ranks (JAX's wording)."""
    if batch % (grad_accum * world):
        raise ValueError(
            f"train.batch={batch} must be divisible by grad_accum x mesh devices "
            f"({grad_accum} x {world}): each of the {grad_accum} micro-batches is sharded "
            f"over the {world}-device '{AXIS}' mesh axis")


def broadcast_state(mesh: Mesh, module: torch.nn.Module) -> None:
    """Every parameter and buffer of ``module`` from rank 0 (the replicated
    state of JAX's mesh)."""
    if mesh.distributed:
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t.data, src=0)


def all_reduce_(mesh: Mesh, flat: torch.Tensor) -> torch.Tensor:
    """``flat`` summed over the group, in place; returned."""
    if mesh.distributed:
        dist.all_reduce(flat)
    return flat


def all_gather_object(mesh: Mesh, obj) -> list:
    """Every rank's ``obj``, in rank order."""
    if not mesh.distributed:
        return [obj]
    out = [None] * mesh.world
    dist.all_gather_object(out, obj)
    return out


def barrier(mesh: Mesh) -> None:
    if mesh.distributed:
        dist.barrier()


def destroy(mesh: Mesh) -> None:
    """End the group, if this run made one."""
    if mesh.distributed and dist.is_initialized():
        dist.destroy_process_group()
