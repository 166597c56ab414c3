"""Stochastic and time-varying uplink models.

The paper prices communication at a single fixed 18.8 Mbps Wi-Fi rate.
Adaptive partitioning (Edgent, 1806.07840) only pays off when the link
moves, so the serving layer models the uplink behind one interface:

    comm_time(nbytes, t) -> seconds to ship nbytes starting at sim time t

Three implementations:

* `FixedRateNetwork` -- the paper's constant link;
* `MarkovNetwork`    -- Gilbert-Elliott two-state (good/bad) Wi-Fi chain,
                        piecewise-constant over dwell slots, fully
                        deterministic under a seed regardless of query
                        order (slots are materialized sequentially);
* `TraceNetwork`     -- replay of a measured bandwidth trace as a step
                        function, optionally periodic.

`repro_torch.offload.latency.comm_time` and
`repro_torch.offload.simulator.simulate_batches` accept any of these in
place of the profile's fixed uplink; the reference's event runtime drives
them with the simulation clock.

Port of `repro.serving.network`: pure numpy, the same arithmetic and the
same seeded draws, so a seed gives the same link in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


class NetworkModel:
    """Uplink with a (possibly time-varying) instantaneous rate.

    Transfers are priced at the rate in effect when they start -- a
    piecewise-constant approximation that keeps the event simulator exact
    and reproducible.
    """

    name = "network"

    def rate_bps(self, t: float = 0.0) -> float:
        raise NotImplementedError

    def rates_bps(self, times) -> np.ndarray:
        """Vectorized instantaneous rates at an array of times -> (N,)
        float64. The base implementation loops over `rate_bps`; subclasses
        whose rate is a step function override it with one indexing op --
        the fleet simulator prices whole transfer windows through this."""
        t = np.asarray(times, np.float64)
        return np.asarray([self.rate_bps(float(x)) for x in t.ravel()],
                          np.float64).reshape(t.shape)

    def comm_time(self, nbytes: float, t: float = 0.0) -> float:
        rate = self.rate_bps(t)
        if rate <= 0:
            raise ValueError(f"{self.name}: non-positive rate {rate} at t={t}")
        return nbytes * 8.0 / rate


@dataclass(frozen=True)
class FixedRateNetwork(NetworkModel):
    """The paper's model: a constant-rate uplink (18.8 Mbps Wi-Fi)."""

    bps: float
    name: str = "fixed"

    def rate_bps(self, t: float = 0.0) -> float:
        return self.bps

    def rates_bps(self, times) -> np.ndarray:
        return np.full(np.asarray(times, np.float64).shape, self.bps)


class MarkovNetwork(NetworkModel):
    """Gilbert-Elliott good/bad Wi-Fi: the chain advances once per
    `dwell_s` slot, so `rate_bps` is deterministic in `t` given the seed --
    slot states are materialized in order, one RNG draw per slot, no matter
    in what order times are queried."""

    name = "markov"

    def __init__(
        self,
        good_bps: float = 18.8e6,
        bad_bps: float = 2.0e6,
        p_good_to_bad: float = 0.2,
        p_bad_to_good: float = 0.2,
        dwell_s: float = 0.5,
        seed: int = 0,
        start_state: int = 0,  # 0 = good, 1 = bad
    ):
        if dwell_s <= 0:
            raise ValueError("dwell_s must be positive")
        self.good_bps = float(good_bps)
        self.bad_bps = float(bad_bps)
        self.p_good_to_bad = float(p_good_to_bad)
        self.p_bad_to_good = float(p_bad_to_good)
        self.dwell_s = float(dwell_s)
        self._rng = np.random.default_rng(seed)
        self._states = [int(start_state)]

    def _state(self, slot: int) -> int:
        while len(self._states) <= slot:
            s = self._states[-1]
            u = self._rng.random()
            if s == 0:
                s = 1 if u < self.p_good_to_bad else 0
            else:
                s = 0 if u < self.p_bad_to_good else 1
            self._states.append(s)
        return self._states[slot]

    def rate_bps(self, t: float = 0.0) -> float:
        slot = int(max(t, 0.0) // self.dwell_s)
        return self.bad_bps if self._state(slot) else self.good_bps

    def rates_bps(self, times) -> np.ndarray:
        t = np.asarray(times, np.float64)
        slots = (np.maximum(t, 0.0) // self.dwell_s).astype(np.int64)
        if slots.size:
            self._state(int(slots.max()))  # materialize in order, once
        states = np.asarray(self._states, np.int64)[slots]
        return np.where(states == 1, self.bad_bps, self.good_bps)


class TraceNetwork(NetworkModel):
    """Bandwidth-trace replay: rate is a step function of time.

    `times_s` must be sorted and start at 0; segment i holds the i-th
    trace rate until `times_s[i+1]`. With `period_s` set, the trace
    loops. The trace array is stored as ``trace_rates_bps`` (the
    `rates_bps` name is the vectorized-lookup method every NetworkModel
    exposes).
    """

    name = "trace"

    def __init__(
        self,
        times_s: Sequence[float],
        rates_bps: Sequence[float],
        period_s: Optional[float] = None,
    ):
        t = np.asarray(times_s, np.float64)
        r = np.asarray(rates_bps, np.float64)
        if t.ndim != 1 or t.shape != r.shape or t.size == 0:
            raise ValueError("times_s and rates_bps must be equal-length 1-D")
        if t[0] != 0.0 or np.any(np.diff(t) <= 0):
            raise ValueError("times_s must start at 0 and strictly increase")
        if period_s is not None and period_s <= t[-1]:
            raise ValueError("period_s must exceed the last trace time")
        self.times_s = t
        self.trace_rates_bps = r
        self.period_s = period_s

    def rate_bps(self, t: float = 0.0) -> float:
        t = max(float(t), 0.0)
        if self.period_s is not None:
            t = t % self.period_s
        i = int(np.searchsorted(self.times_s, t, side="right")) - 1
        return float(self.trace_rates_bps[max(i, 0)])

    def rates_bps(self, times) -> np.ndarray:
        t = np.maximum(np.asarray(times, np.float64), 0.0)
        if self.period_s is not None:
            t = t % self.period_s
        i = np.searchsorted(self.times_s, t, side="right") - 1
        return self.trace_rates_bps[np.maximum(i, 0)]


def network_for(profile) -> FixedRateNetwork:
    """The fixed-rate network a LatencyProfile implies (its uplink_bps)."""
    return FixedRateNetwork(profile.uplink_bps)
