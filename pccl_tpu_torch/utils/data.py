"""Token data pipeline: random-crop batches and a device prefetcher.

`TokenDataset` is the JAX package's (pccl_tpu/utils/data.py), copied: pure
numpy, and the same (seed, worker_index) gives the same stream in both
packages, so data-parallel peers of either sample disjointly.

`prefetch_to_device` stages upcoming batches on the card from a background
thread, so the host -> device copy of batch k+1 runs under the compute of
batch k: each batch is pinned and copied on a side stream, and the consumer's
stream waits on an event recorded after the copy.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, Tuple

import numpy as np
import torch

from .._device import resolve_device


class TokenDataset:
    """Random-crop next-token batches over a 1-D token array (in memory or
    an np.memmap: nothing is copied until a crop is sampled). Each
    (seed, worker_index) pair is its own deterministic stream; peers pass
    their rank so that a data-parallel group samples disjointly."""

    def __init__(self, tokens: np.ndarray, block_size: int, batch_size: int,
                 *, seed: int = 0, worker_index: int = 0):
        if tokens.ndim != 1:
            raise ValueError(f"tokens must be 1-D, got shape {tokens.shape}")
        if len(tokens) < block_size + 2:
            raise ValueError(
                f"need > block_size+1={block_size + 1} tokens, got {len(tokens)}")
        self.tokens = tokens
        self.block_size = block_size
        self.batch_size = batch_size
        self._rng = np.random.default_rng((seed << 20) ^ (worker_index + 1))

    def sample(self) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, targets) int32 [B, T]: one random-crop batch."""
        B, T = self.batch_size, self.block_size
        starts = self._rng.integers(0, len(self.tokens) - T - 1, size=B)
        x = np.stack([self.tokens[s:s + T] for s in starts])
        y = np.stack([self.tokens[s + 1:s + T + 1] for s in starts])
        return x.astype(np.int32), y.astype(np.int32)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.sample()


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
