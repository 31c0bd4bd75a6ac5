"""Host-to-device prefetch (counterpart of ``se_tpu/data/prefetch.py``).

A background thread turns each batch into tensors and, on a CUDA device,
copies it into pinned host memory and from there to the card on a side
stream, ``depth`` batches ahead of the step that reads them.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import torch


def prefetch_to_device(iterator: Iterable, depth: int = 2, device="cuda") -> Iterator:
    """Yield each batch of ``iterator`` (a tuple of arrays) as a tuple of
    tensors on ``device``, with up to ``depth`` batches staged ahead.

    On a CUDA device the producer copies on its own stream.  Before a batch
    is handed over, the consumer's current stream waits for the event
    recorded after that batch's copies, so no kernel reads a tensor before
    it lands; and each tensor is recorded on the consumer's stream, so the
    caching allocator does not hand its memory to a later copy while work
    queued there still reads it.  On ``"cpu"`` the batches become CPU
    tensors and nothing is pinned.

    If the consumer abandons the generator mid-epoch, its close sets a stop
    flag that the producer's bounded ``put`` polls, so the thread exits and
    the staged batches are released.
    """
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    copy_stream = torch.cuda.Stream(dev) if cuda else None

    def place(batch):
        tensors = [torch.as_tensor(x) for x in batch]
        if not cuda:
            return tuple(tensors), None
        with torch.cuda.stream(copy_stream):
            tensors = [t.pin_memory().to(dev, non_blocking=True) for t in tensors]
            done = torch.cuda.Event()
            done.record(copy_stream)
        return tuple(tensors), done

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        """Bounded put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not put(place(batch)):
                    return
        except Exception as e:  # raised again on the consumer's side
            err.append(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            tensors, done = item
            if done is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(done)
                for x in tensors:
                    x.record_stream(consumer)
            yield tensors
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
