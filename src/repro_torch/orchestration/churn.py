"""Cell churn: seeded join/leave event schedules.

A `ChurnSchedule` is an immutable, time-sorted list of `ChurnEvent`s; the
`Orchestrator` holds its own cursor into it and applies every event whose
time has come at each window boundary (events therefore take effect at
the first boundary >= their scheduled time -- the same window-boundary
granularity every other config change in the fleet simulator has).
"fail"/"recover" are not separate kinds: a failure IS a leave and a
recovery IS a join; what differs is who scheduled it, which the schedule
does not model.

Port of `repro.orchestration.churn`: pure Python and numpy, the same
seeded draws, so a seed gives the same schedule in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

import numpy as np

JOIN = "join"
LEAVE = "leave"


@dataclass(frozen=True)
class ChurnEvent:
    t_s: float
    cell: int
    kind: str  # JOIN | LEAVE

    def __post_init__(self):
        if self.kind not in (JOIN, LEAVE):
            raise ValueError(f"kind must be {JOIN!r} or {LEAVE!r}, got {self.kind!r}")
        if self.t_s < 0:
            raise ValueError("t_s must be >= 0")
        if self.cell < 0:
            raise ValueError("cell must be >= 0")


class ChurnSchedule:
    """Time-sorted churn events (ties broken by cell, then join-before-
    leave so a same-instant bounce nets out to down)."""

    def __init__(self, events: Iterable[ChurnEvent] = ()):
        self.events: Tuple[ChurnEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.t_s, e.cell, e.kind != JOIN))
        )

    def __len__(self) -> int:
        return len(self.events)

    def due(self, cursor: int, t_s: float) -> Tuple[Tuple[ChurnEvent, ...], int]:
        """Events at index >= cursor with scheduled time <= t_s ->
        (events, new cursor). The caller owns the cursor, so one schedule
        can drive many runs."""
        j = cursor
        while j < len(self.events) and self.events[j].t_s <= t_s:
            j += 1
        return self.events[cursor:j], j

    @classmethod
    def outage(
        cls, cells: Sequence[int], start_s: float, duration_s: float
    ) -> "ChurnSchedule":
        """The simplest correlated failure: `cells` all leave at `start_s`
        and rejoin `duration_s` later."""
        if duration_s <= 0:
            raise ValueError("duration_s must be positive")
        evs: List[ChurnEvent] = []
        for c in cells:
            evs.append(ChurnEvent(start_s, c, LEAVE))
            evs.append(ChurnEvent(start_s + duration_s, c, JOIN))
        return cls(evs)

    @classmethod
    def random(
        cls,
        n_cells: int,
        horizon_s: float,
        seed: int = 0,
        outage_rate_hz: float = 0.02,
        mean_downtime_s: float = 5.0,
    ) -> "ChurnSchedule":
        """Seeded background churn: per cell, outages arrive Poisson at
        `outage_rate_hz` and last Exp(`mean_downtime_s`). Deterministic
        under the seed; an outage still open at the horizon never rejoins
        (the run ends with the cell down)."""
        rng = np.random.default_rng(seed)
        evs: List[ChurnEvent] = []
        for c in range(n_cells):
            t = float(rng.exponential(1.0 / outage_rate_hz))
            while t < horizon_s:
                dur = float(rng.exponential(mean_downtime_s))
                evs.append(ChurnEvent(t, c, LEAVE))
                if t + dur < horizon_s:
                    evs.append(ChurnEvent(t + dur, c, JOIN))
                t += dur + float(rng.exponential(1.0 / outage_rate_hz))
        return cls(evs)
