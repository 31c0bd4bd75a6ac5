"""Dataset and loader over the ``[N, 2, T]`` waveform corpus (counterpart of
``se_tpu/data/dataset.py``).

Rows are (noisy, clean).  The loader yields numpy batches; the prefetch
stage (``data/prefetch.py``) turns them into tensors on the device.  The
shuffle is keyed by ``(seed, epoch)`` with numpy's generator, as in the JAX
package, so both packages' loaders give the same batches for every seed and
epoch, and a resumed run continues the order instead of replaying it.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from .synth import mix_at_snr


class WaveDataset:
    """Paired (noisy, clean) waveforms from one array of shape ``[N, 2, T]``,
    memory-mapped when given a path.  Test mode indexes ``input[type][snr]``
    first, the reference's nested test corpus layout."""

    def __init__(self, path_or_array, mode: str = "train", type: int = 0, snr: int = 0,
                 mmap: bool = True):
        if isinstance(path_or_array, np.ndarray):
            data = path_or_array
        else:
            data = np.load(path_or_array, mmap_mode="r" if mmap else None)
        if mode == "test":
            data = data[type][snr]
        if data.ndim != 3 or data.shape[1] != 2:
            raise ValueError(f"expected a [N, 2, T] corpus, got shape {data.shape}")
        self.mode = mode
        self.data = data

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        pair = self.data[idx]
        return np.asarray(pair[0], np.float32), np.asarray(pair[1], np.float32)


def gather_pairs(dataset, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A batch of (noisy, clean) rows: an array-backed dataset is indexed in
    one shot, any other item by item."""
    data = getattr(dataset, "data", None)
    if data is not None:
        arr = np.asarray(data[idx], np.float32)
        return arr[:, 0], arr[:, 1]
    pairs = [dataset[int(i)] for i in idx]
    noisy = np.stack([p[0] for p in pairs]).astype(np.float32)
    clean = np.stack([p[1] for p in pairs]).astype(np.float32)
    return noisy, clean


class MixingDataset:
    """Noisy mixtures made on the fly: a fresh noise crop and a random SNR
    per draw (``mix_at_snr``).  Every item is keyed by ``(seed, epoch,
    index)``, so a run is reproducible from its seed while each epoch sees
    new mixtures; ``fresh_each_epoch=False`` keeps epoch 0's.  The loader
    sets the epoch when an epoch starts."""

    def __init__(self, clean, noises, snrs, seed: int = 0, fresh_each_epoch: bool = True):
        self.clean = [np.asarray(c, np.float32) for c in clean]
        self.noises = [np.asarray(n, np.float32) for n in noises]
        if not self.noises:
            raise ValueError("MixingDataset needs at least one noise signal")
        self.snrs = [float(s) for s in snrs]
        self.seed = seed
        self.fresh_each_epoch = fresh_each_epoch
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.clean)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        e = self._epoch if self.fresh_each_epoch else 0
        rng = np.random.default_rng((self.seed, e, idx))
        snr = self.snrs[rng.integers(len(self.snrs))]
        noise = self.noises[rng.integers(len(self.noises))]
        noisy, clean = mix_at_snr(self.clean[idx], noise, snr, rng)
        return noisy.astype(np.float32), clean.astype(np.float32)


class DataLoader:
    """Batches of ``(noisy [B, T], clean [B, T])`` numpy arrays with the
    reference loaders' shuffle and drop_last semantics."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Position the loader at ``epoch`` (0-based): the next iteration
        draws that epoch's order."""
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            yield gather_pairs(self.dataset, order[start : start + self.batch_size])


def create_dataloader(mode: str, path_or_array=None, batch: int = 10, type: int = 0,
                      snr: int = 0, seed: int = 0) -> DataLoader:
    """The reference's ``create_dataloader``: train shuffles and drops the
    last partial batch; valid and test run in order."""
    ds = WaveDataset(path_or_array, mode=mode, type=type, snr=snr)
    if mode == "train":
        return DataLoader(ds, batch, shuffle=True, drop_last=True, seed=seed)
    return DataLoader(ds, batch, shuffle=False, drop_last=False)
