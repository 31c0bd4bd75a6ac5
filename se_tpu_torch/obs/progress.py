"""Console progress bar over a loader (counterpart of ``se_tpu/obs/progress.py``)."""

from __future__ import annotations

import time


class Bar:
    """Wrap any sized iterable of batches; prints ``i/N [===>...] ETA``."""

    DISPLAY_LENGTH = 50

    def __init__(self, loader, total: int | None = None):
        self.loader = loader
        self.total = total if total is not None else len(loader)

    def __len__(self):
        return self.total

    def __iter__(self):
        start = time.time()
        for idx, batch in enumerate(self.loader):
            rate = (idx + 1) / self.total
            eta = (time.time() - start) / idx * (self.total - idx) if idx else 0.0
            bar = ("=" * int(rate * self.DISPLAY_LENGTH) + ">").ljust(self.DISPLAY_LENGTH, ".")
            print(f"\r{idx + 1}/{self.total}: [{bar}] - ETA {eta:.1f}s", end="", flush=True)
            yield batch
        print()
