"""Each rank's share of every global batch (counterpart of
``se_tpu/data/multihost.py``).

Every rank draws the same shuffled order of the ``[N, 2, T]`` corpus, keyed
by (seed, epoch), and reads only its own rows of each global batch.  With
``grad_accum = A`` a global batch of B rows is A micro-batches of B/A
consecutive rows, and a rank's rows are its consecutive B/(A W) of each
micro-batch in turn: cut into A, the k-th piece is its slice of the global
k-th micro-batch, as the JAX package's global array gives it.  (A
consecutive slice of B/W rows would not be: at B=8, A=2, W=2 rank 0's first
micro-batch would be global rows {0, 1, 4, 5}, where JAX's is {0, 1, 2, 3}.)
JAX's ``make_global_batch`` has no counterpart: each rank keeps its rows.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from .dataset import gather_pairs


def host_shard(n: int, process_index: int, process_count: int):
    """Contiguous ``[start, stop)`` share of an ``n``-element index space
    owned by rank ``process_index``: as even as possible, the first ``n %
    process_count`` ranks taking one more."""
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} of {process_count}")
    base, extra = divmod(n, process_count)
    start = process_index * base + min(process_index, extra)
    stop = start + base + (1 if process_index < extra else 0)
    return start, stop


class MultiHostLoader:
    """Rank ``process_index``'s ``(noisy, clean)`` float32 rows of each
    global batch of ``global_batch`` rows over ``process_count`` ranks:
    ``global_batch // process_count`` of them, ordered by micro-batch
    (module docstring).

    ``drop_last=True`` (training) drops a partial last global batch.
    ``drop_last=False`` (validation) wrap-pads it cyclically to a full
    global batch; ``valid_per_batch`` gives each batch's count of real
    global rows and ``local_valid`` this rank's share of them, which lead
    its rows.
    """

    def __init__(self, dataset, global_batch: int, process_index: int, process_count: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 grad_accum: int = 1):
        self.dataset = dataset
        self.global_batch = global_batch
        self.process_index = process_index
        self.process_count = process_count
        if global_batch % self.process_count:
            raise ValueError(f"global_batch {global_batch} not divisible by process_count "
                             f"{self.process_count}")
        if global_batch % (grad_accum * self.process_count):
            raise ValueError(f"global_batch {global_batch} not divisible by grad_accum x "
                             f"process_count ({grad_accum} x {self.process_count})")
        self.local_batch = global_batch // self.process_count
        micro = global_batch // grad_accum
        share = micro // self.process_count
        # this rank's positions within a global batch, in increasing order
        self.positions = np.concatenate([
            np.arange(m * micro + self.process_index * share,
                      m * micro + (self.process_index + 1) * share)
            for m in range(grad_accum)])
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Position the loader at ``epoch`` (0-based): the shuffle is keyed by
        (seed, epoch), so a resume sets the counter."""
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.global_batch
        return -(-n // self.global_batch)

    @property
    def valid_per_batch(self):
        """Global count of real (not wrap-padded) rows per yielded batch."""
        n = len(self.dataset)
        counts = [self.global_batch] * (n // self.global_batch)
        rem = n % self.global_batch
        if rem and not self.drop_last:
            counts.append(rem)
        return counts

    def local_valid(self, global_valid: int) -> int:
        """This rank's count of real rows in a batch whose first
        ``global_valid`` global rows are real: its leading rows, its
        positions being in increasing order."""
        return int(np.count_nonzero(self.positions < global_valid))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            # the same on every rank: keyed only by (seed, epoch)
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1
        stop = (n // self.global_batch) * self.global_batch
        for start in range(0, stop, self.global_batch):
            rows = order[start : start + self.global_batch]
            yield gather_pairs(self.dataset, rows[self.positions])
        if n - stop and not self.drop_last:
            # wrap-pad the tail cyclically to a full global batch
            idx = np.resize(order[stop:], self.global_batch)[self.positions]
            yield gather_pairs(self.dataset, idx)
