"""Input pipeline: deterministic batching with background prefetch (port
of `repro.data.pipeline`).

Host-side numpy iterators that yield globally-batched arrays, exactly the
reference's; `prefetch` keeps `size` batches ahead of the step in a
background thread and, given a `device`, moves each batch's arrays there
as tensors (the reference places them against a `jax.sharding`).

Under a data mesh of W ranks (`launch.mesh.join_ranks`) every rank reads
the same seeded stream and keeps its `Shard`: rows [r*B/W, (r+1)*B/W) of
each global batch of B rows, the slice `jax.device_put` against the
batch sharding gives data shard r. Where W does not divide B every rank
keeps the whole batch, as the reference's `fit_spec` drops a sharding
that does not divide.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

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


class Shard(dict):
    """A rank's rows [lo, hi) of a global batch of `rows` rows, as a dict
    of arrays or tensors. `training.loop`'s step takes a Shard as the
    rank's part and any other batch as the global one."""

    def __init__(self, items, lo: int, hi: int, rows: int):
        super().__init__(items)
        self.lo, self.hi, self.rows = lo, hi, rows

    @property
    def sharded(self) -> bool:
        """Whether the ranks hold different rows (else each holds all)."""
        return self.hi - self.lo < self.rows


def data_rows(rows: int, mesh) -> Tuple[int, int]:
    """[lo, hi): this rank's rows of a global batch of `rows` under `mesh`
    (its data axes, pod then data, row-major, as `sharding.data_split`
    reads them; a mesh that names no axes has a data axis only; None or
    one rank: all of them). All of them too when the ranks do not divide
    `rows`."""
    if mesh is None:
        return 0, rows
    w, r = 1, 0
    for a in ("pod", "data"):
        if a in getattr(mesh, "axis_names", ("data",)):
            c = mesh.coordinate(a)
            r = None if r is None or c is None else r * mesh.axis_size(a) + c
            w *= mesh.axis_size(a)
    if w == 1 or r is None or rows % w:
        return 0, rows
    n = rows // w
    return r * n, (r + 1) * n


def shard_batch(batch: dict, mesh) -> Shard:
    """This rank's `Shard` of a global batch (every array's leading dim is
    the batch)."""
    rows = len(next(iter(batch.values())))
    lo, hi = data_rows(rows, mesh)
    return Shard({k: v[lo:hi] for k, v in batch.items()}, lo, hi, rows)


def prefetch(it, size: int = 2, device=None, mesh=None):
    """Background-thread prefetch; with `device`, each array of a batch
    arrives as a tensor on it (None leaves the batches as they are). With
    a data `mesh`, each batch is first cut to this rank's `Shard`, so only
    its rows move."""
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()

    def worker():
        for item in it:
            if mesh is not None:
                item = shard_batch(item, mesh)
            if device is not None:
                moved = {k: torch.as_tensor(v).to(device) for k, v in item.items()}
                item = (Shard(moved, item.lo, item.hi, item.rows) if isinstance(item, Shard)
                        else moved)
            q.put(item)
        q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        yield item
