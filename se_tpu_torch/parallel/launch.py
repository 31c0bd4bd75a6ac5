"""Ranks of a group on this host, started from Python (what torchrun does
for a CLI): each is a spawned process that finds torchrun's environment
(``MASTER_ADDR`` on localhost, a free ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), so
``mesh.make_mesh`` makes its group.  The tests run two gloo ranks on the
CPU this way, and ``chip_smoke.py`` two on one card.
"""

from __future__ import annotations

import os
import queue
import socket
import traceback

import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on localhost that no socket holds now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(fn, args, rank: int, world: int, port: int, results) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    try:
        results.put((rank, True, fn(*args)))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world: int, args=(), timeout: float = 600.0) -> list:
    """``fn(*args)`` in ``world`` spawned processes, ranks 0 to ``world - 1``
    of a group on localhost -> each rank's return value, in rank order.
    ``fn`` must be importable by name (it is pickled by reference) and its
    result picklable.  Raises with the rank's traceback if one fails, and
    stops every rank still running after ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank, args=(fn, args, r, world, port, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, failed = {}, []
    try:
        for _ in range(world):
            try:
                rank, ok, value = results.get(timeout=timeout)
            except queue.Empty:
                failed.append(f"no result within {timeout} s")
                break
            if ok:
                out[rank] = value
            else:
                failed.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=30 if not failed else 5)
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        raise RuntimeError("a rank failed: " + "\n".join(failed))
    return [out[r] for r in range(world)]
