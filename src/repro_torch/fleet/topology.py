"""Multi-cell fleet topology.

A *cell* is the unit the paper studies once: a group of edge devices
behind ONE shared uplink, serving one request stream under one local
context (distortion) regime. A fleet is C such cells feeding a single
shared cloud tier. Each cell owns its workload seed, its `NetworkModel`,
and (optionally) its `ContextSchedule`, so a 64-cell fleet models 64
sites with different links and different weather -- the regime Danek et
al. (2025) measure, where shared-uplink contention across many devices
decides whether offloading pays off.

Workloads are materialized as plain arrays at construction
(`CellWorkload`), never as per-request objects: the fleet simulator
consumes arrival/sample/device columns directly.

Port of `repro.fleet.topology`: pure numpy, the same seeded draws, so a
seed gives the same requests in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.serving.drift import ContextSchedule
from repro_torch.serving.network import NetworkModel


@dataclass
class CellWorkload:
    """One cell's request stream as columns (sorted by arrival)."""

    arrival_s: np.ndarray  # (N,) float64, sorted
    sample: np.ndarray  # (N,) int64 indices into the gate table
    device: np.ndarray  # (N,) int64 in [0, n_devices)

    def __post_init__(self):
        self.arrival_s = np.asarray(self.arrival_s, np.float64)
        self.sample = np.asarray(self.sample, np.int64)
        self.device = np.asarray(self.device, np.int64)
        n = self.arrival_s.shape[0]
        if self.sample.shape != (n,) or self.device.shape != (n,):
            raise ValueError("arrival_s/sample/device must be equal-length 1-D")
        if n and np.any(np.diff(self.arrival_s) < 0):
            raise ValueError("arrival_s must be sorted")

    def __len__(self) -> int:
        return int(self.arrival_s.shape[0])


@dataclass(frozen=True)
class DiurnalEnvelope:
    """Deterministic sinusoidal rate modulation for Poisson arrivals.

    The instantaneous rate is ``base_rate * (1 + amplitude *
    sin(2*pi*(t + phase_s)/period_s))`` -- the fleet-realism knob the
    per-cell constant-rate Poisson lacks (traffic peaks and troughs over
    the simulated day). `period_s` is whatever "a day" means at the
    simulation's time scale; staggering `phase_s` across cells models
    sites in different time zones. ``amplitude == 1.0`` is allowed and
    means the trough rate touches exactly zero (a site that goes fully
    quiet once per period); the thinning sampler handles the zero-rate
    stretch by construction (keep probability 0 there).
    """

    period_s: float = 60.0
    amplitude: float = 0.5  # in [0, 1]: 1.0 -> zero-rate trough
    phase_s: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.amplitude <= 1.0:
            raise ValueError("amplitude must be in [0, 1]")
        if self.period_s <= 0:
            raise ValueError("period_s must be positive")

    def rate_factor(self, t) -> np.ndarray:
        """Multiplier on the base rate at time(s) t."""
        t = np.asarray(t, np.float64)
        return 1.0 + self.amplitude * np.sin(
            2.0 * np.pi * (t + self.phase_s) / self.period_s
        )


def poisson_cell_workload(
    rate_hz: float,
    n_requests: int,
    n_samples: int,
    n_devices: int = 1,
    seed: int = 0,
    envelope: Optional[DiurnalEnvelope] = None,
) -> CellWorkload:
    """Poisson arrivals; samples walk the dataset sequentially and devices
    round-robin -- the same conventions as `repro_torch.serving.workload`, as
    columns instead of `Request` objects.

    `envelope` switches the stream to an inhomogeneous Poisson process
    under the given diurnal rate modulation, materialized by seeded
    thinning (candidates at the peak rate, each kept with probability
    rate(t)/peak) -- deterministic under the seed, exactly `n_requests`
    arrivals. The default (None) keeps the homogeneous stream
    bit-identical to what this function always produced."""
    rng = np.random.default_rng(seed)
    if envelope is None:
        arrivals = np.cumsum(rng.exponential(1.0 / rate_hz, n_requests))
    else:
        peak = rate_hz * (1.0 + envelope.amplitude)
        arrivals = np.empty(n_requests, np.float64)
        count, t = 0, 0.0
        while count < n_requests:
            m = 2 * (n_requests - count) + 16
            cand = t + np.cumsum(rng.exponential(1.0 / peak, m))
            keep = rng.random(m) * (1.0 + envelope.amplitude) \
                < envelope.rate_factor(cand)
            acc = cand[keep]
            take = min(len(acc), n_requests - count)
            arrivals[count:count + take] = acc[:take]
            count += take
            t = float(cand[-1])
    idx = np.arange(n_requests, dtype=np.int64)
    return CellWorkload(arrivals, idx % n_samples, idx % n_devices)


@dataclass
class CellConfig:
    """One cell: device group + shared uplink + local context regime.

    ``initially_active=False`` models a cell that exists in the topology
    but has not joined the fleet yet (it comes up mid-run via an
    orchestration ``join`` event); until then its arrivals are shed like
    a failed cell's.
    """

    network: NetworkModel
    workload: CellWorkload
    n_devices: int = 1
    schedule: Optional[ContextSchedule] = None  # None -> static context
    deadline_s: Optional[float] = None
    initially_active: bool = True

    def __post_init__(self):
        if self.n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        if len(self.workload) and int(self.workload.device.max()) >= self.n_devices:
            raise ValueError(
                f"workload uses device {int(self.workload.device.max())} but "
                f"the cell has {self.n_devices} device(s)"
            )


@dataclass
class FleetTopology:
    """C cells -> one shared cloud tier of `cloud_servers` servers.

    Cells are arranged on a ring for orchestration purposes: when a cell
    fails or leaves mid-run (`repro_torch.orchestration`), its arrivals are shed
    to the nearest ACTIVE neighbor by ring distance (`shed_order`), and to
    the shared cloud over a backhaul when no live neighbor exists. The
    per-run activation state itself lives in the simulator (seeded event
    schedules move it); the topology only declares the starting mask
    (`initial_active_mask` from each cell's ``initially_active``) and the
    neighbor geometry.
    """

    cells: List[CellConfig]
    cloud_servers: int = 1

    def __post_init__(self):
        if not self.cells:
            raise ValueError("a fleet needs at least one cell")
        if self.cloud_servers < 1:
            raise ValueError("cloud_servers must be >= 1")

    @property
    def n_cells(self) -> int:
        return len(self.cells)

    def initial_active_mask(self) -> np.ndarray:
        """(C,) bool: which cells are up at t=0."""
        return np.asarray([c.initially_active for c in self.cells], bool)

    def shed_order(self, cell: int) -> np.ndarray:
        """Every OTHER cell ordered by ring distance from `cell` (ties
        broken toward the lower index): the order in which a dead cell's
        load looks for a live host."""
        if not 0 <= cell < self.n_cells:
            raise ValueError(f"no cell {cell} in a {self.n_cells}-cell fleet")
        others = np.asarray(
            [c for c in range(self.n_cells) if c != cell], np.int64
        )
        if others.size == 0:
            return others
        dist = np.abs(others - cell)
        dist = np.minimum(dist, self.n_cells - dist)
        return others[np.lexsort((others, dist))]

    @property
    def n_requests(self) -> int:
        return sum(len(c.workload) for c in self.cells)

    @property
    def horizon_s(self) -> float:
        """Last arrival across the fleet (the simulated span lower bound)."""
        return max(
            float(c.workload.arrival_s[-1]) if len(c.workload) else 0.0
            for c in self.cells
        )
