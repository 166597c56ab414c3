"""Every random draw of a run comes from ``--seed`` through a named stream.

A stream and an index (the batch number, say) give one generator, on the
device the draw is made on, so the same seed gives the same weights,
validation set, labels and batches, and batch k of the window can be drawn
again after the window for the comparison.
"""
from __future__ import annotations

import numpy as np
import torch

STREAMS = ("weights", "data", "validation", "labels", "warmup", "window", "check")


def generator(seed: int, stream: str, index: int = 0, device="cuda") -> torch.Generator:
    """A fresh generator for (seed, stream, index) on `device`."""
    state = np.random.SeedSequence([int(seed) % 2**64, STREAMS.index(stream), int(index)])
    word = state.generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed((int(word[0]) << 31) ^ int(word[1]))


def numpy_rng(seed: int, stream: str, index: int = 0) -> np.random.Generator:
    """A host generator for (seed, stream, index): choices, not data."""
    return np.random.default_rng([int(seed) % 2**64, STREAMS.index(stream), int(index)])
