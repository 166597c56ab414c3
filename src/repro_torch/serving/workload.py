"""Request generators for the serving runtime.

Port of `repro.serving.workload` (pure numpy).

A workload is a list of `Request`s sorted by arrival time. Every generator
is fully seeded/deterministic; samples index into whatever dataset (or
precomputed-logits array) the compute core serves. The default sequential
sample order walks the dataset exactly once per pass, so aggregate gate
statistics match the offline batch simulator on the same logits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class Request:
    req_id: int
    arrival_s: float
    sample: int  # index into the dataset / logits arrays
    device: int  # which edge device receives it
    deadline_s: Optional[float] = None  # per-request latency budget


def _build(arrivals, n_samples, n_devices, deadline_s, sample_order, seed):
    if sample_order == "sequential":
        samples = [i % n_samples for i in range(len(arrivals))]
    elif sample_order == "random":
        rng = np.random.default_rng(seed + 1)
        samples = rng.integers(0, n_samples, len(arrivals)).tolist()
    else:
        raise ValueError(f"unknown sample_order {sample_order!r}")
    return [
        Request(
            req_id=i,
            arrival_s=float(t),
            sample=samples[i],
            device=i % n_devices,
            deadline_s=deadline_s,
        )
        for i, t in enumerate(arrivals)
    ]


def poisson_workload(
    rate_hz: float,
    n_requests: int,
    n_samples: int,
    n_devices: int = 1,
    deadline_s: Optional[float] = None,
    sample_order: str = "sequential",
    seed: int = 0,
) -> List[Request]:
    """Poisson arrivals at `rate_hz` (exponential i.i.d. interarrivals)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_hz, n_requests))
    return _build(arrivals, n_samples, n_devices, deadline_s, sample_order, seed)


def constant_workload(
    rate_hz: float,
    n_requests: int,
    n_samples: int,
    n_devices: int = 1,
    deadline_s: Optional[float] = None,
    sample_order: str = "sequential",
    seed: int = 0,
) -> List[Request]:
    """Deterministically spaced arrivals (period 1/rate_hz) -- with the
    period above the worst-case service time, queues provably stay empty,
    which is the static special case the runtime tests pin down."""
    period = 1.0 / rate_hz
    arrivals = period * np.arange(1, n_requests + 1)
    return _build(arrivals, n_samples, n_devices, deadline_s, sample_order, seed)


def trace_workload(
    arrival_times_s: Sequence[float],
    n_samples: int,
    n_devices: int = 1,
    deadline_s: Optional[float] = None,
    sample_order: str = "sequential",
    seed: int = 0,
) -> List[Request]:
    """Replay measured arrival timestamps (must be sorted)."""
    arrivals = np.asarray(arrival_times_s, np.float64)
    if np.any(np.diff(arrivals) < 0):
        raise ValueError("arrival_times_s must be sorted")
    return _build(arrivals, n_samples, n_devices, deadline_s, sample_order, seed)
