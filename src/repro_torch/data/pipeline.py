"""Input pipeline: deterministic batching with background prefetch (port
of `repro.data.pipeline`).

Host-side numpy iterators that yield globally-batched arrays, exactly the
reference's; `prefetch` keeps `size` batches ahead of the step in a
background thread and, given a `device`, moves each batch's arrays there
as tensors (the reference places them against a `jax.sharding`).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


class BatchIterator:
    """Deterministic epoch-shuffled batches over in-memory arrays."""

    def __init__(self, arrays: dict, batch_size: int, seed: int = 0, drop_last=True):
        self.arrays = arrays
        self.n = len(next(iter(arrays.values())))
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[dict]:
        epoch = 0
        while True:
            rng = np.random.default_rng((self.seed, epoch))
            order = rng.permutation(self.n)
            stop = self.n - self.batch_size + 1 if self.drop_last else self.n
            for s in range(0, stop, self.batch_size):
                idx = order[s : s + self.batch_size]
                yield {k: v[idx] for k, v in self.arrays.items()}
            epoch += 1


class TokenIterator:
    """Contiguous (batch, seq+1) windows over a token stream -> tokens/labels."""

    def __init__(self, stream: np.ndarray, batch_size: int, seq_len: int, seed=0):
        self.stream = stream
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        hi = len(self.stream) - self.seq_len - 1
        while True:
            starts = rng.integers(0, hi, self.batch_size)
            win = np.stack(
                [self.stream[s : s + self.seq_len + 1] for s in starts]
            )
            yield {"tokens": win[:, :-1].astype(np.int32), "labels": win[:, 1:].astype(np.int32)}


def prefetch(it, size: int = 2, device=None):
    """Background-thread prefetch; with `device`, each array of a batch
    arrives as a tensor on it (None leaves the batches as they are)."""
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()

    def worker():
        for item in it:
            if device is not None:
                item = {k: torch.as_tensor(v).to(device) for k, v in item.items()}
            q.put(item)
        q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        yield item
