"""Token data pipeline: a device prefetcher.

`prefetch_to_device` stages upcoming batches on the card from a background
thread, so the host -> device copy of batch k+1 runs under the compute of
batch k: each batch is pinned and copied on a side stream, and the consumer's
stream waits on an event recorded after the copy.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from .._device import resolve_device


def _map(item: Any, fn) -> Any:
    """fn over the arrays of a (nested) tuple or list."""
    if isinstance(item, (tuple, list)):
        return type(item)(_map(x, fn) for x in item)
    return fn(item)


def prefetch_to_device(it: Iterable, size: int = 2, device="cuda") -> Iterator:
    """Yield each item of `it` (numpy arrays, or tuples and lists of them)
    as tensors on `device`, keeping up to `size` items already copied. On a
    CUDA device each array is pinned and copied on a side stream; the
    consumer's current stream waits for the copy before the item is
    yielded. On the CPU the items are only converted. The feeder thread
    stops when `it` ends or the generator is closed."""
    dev = resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    end = object()

    def put(x) -> None:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.2)
                return
            except queue.Full:
                continue

    def stage(arr):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if side is None:
            return t
        return t.pin_memory().to(dev, non_blocking=True)

    def feed() -> None:
        try:
            for item in it:
                if stop.is_set():
                    return
                if side is None:
                    put((_map(item, stage), None))
                    continue
                with torch.cuda.stream(side):
                    staged = _map(item, stage)
                    done = torch.cuda.Event()
                    done.record(side)
                put((staged, done))
            put(end)
        except BaseException as e:  # noqa: BLE001 - raised on next()
            put(e)

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    try:
        while True:
            got = q.get()
            if got is end:
                return
            if isinstance(got, BaseException):
                raise got
            item, done = got
            if done is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(done)
                # memory made on the side stream is used on this one
                _map(item, lambda x: x.record_stream(cur))
            yield item
    finally:
        stop.set()
