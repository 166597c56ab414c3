"""Per-cell QoS monitoring against declared SLOs, with hysteresis.

The monitor watches `FleetTelemetry.cell_qos_estimate` -- the LIVE
trailing-window view the orchestrated simulator maintains (edge
completions exact, offloaded ones streamed through the incremental cloud
solve) -- and compares three tails against a `CellSLO`:

* ``p99_ms``             -- trailing-window p99 end-to-end latency;
* ``deadline_miss_rate`` -- share of completed requests past deadline;
* ``reliability_gap``    -- |on-device accuracy - mean p_tar|, the
                            paper's calibration contract, auditable at
                            the edge without the cloud;
* ``ece`` / ``coverage`` -- streaming calibration health (windowed
                            expected calibration error and on-device
                            precision) from the live reliability-bin
                            stream; ``ece_cap`` is a cap, while
                            ``coverage_floor`` trips when precision
                            drops BELOW the floor.

Hysteresis both ways: a cell TRIPS only after `trip_after` consecutive
violating windows and, once tripped, CLEARS only after `clear_after`
consecutive clean ones -- a single bad (or good) window moves nothing. A
window with fewer than ``min_requests`` resolved completions returns no
verdict and freezes both streaks: silence is not evidence of health, and
a drained cell must not clear a trip by being idle.

Port of `repro.orchestration.qos`: host numpy, the reference's state
machine verdict for verdict.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: The SLO fields checked, in check order (first violation names the trip).
QOS_METRICS = (
    "p99_ms",
    "deadline_miss_rate",
    "reliability_gap",
    "reliability_shortfall",
    "ece",
    "coverage",
)
#: Metrics whose evidence is GATE samples (on-device label outcomes), not
#: completions -- judged against ``min_gate_samples`` instead.
_GATE_METRICS = ("reliability_gap", "reliability_shortfall")
#: Calibration metrics: evidence is the live calibration stream (every
#: gated request, offloaded ones included) -- judged against
#: ``min_gate_samples`` on the ``cal_samples`` count.
_CAL_METRICS = ("ece", "coverage")
#: Metrics where LOWER values violate the SLO (the cap is a floor).
_LOWER_IS_BAD = frozenset({"coverage"})
#: SLO field name per metric where they differ (the cap/floor naming).
_SLO_FIELD = {"ece": "ece_cap", "coverage": "coverage_floor"}


def _slo_threshold(slo: "CellSLO", metric: str) -> Optional[float]:
    return getattr(slo, _SLO_FIELD.get(metric, metric))


@dataclass(frozen=True)
class CellSLO:
    """Per-cell service-level objectives; None = unwatched metric.

    ``reliability_gap`` caps the symmetric |on-device accuracy - mean
    p_tar|; ``reliability_shortfall`` caps only the dangerous direction,
    max(0, mean p_tar - accuracy) -- over-delivering on the contract is
    never an incident. Reliability verdicts need ``min_gate_samples``
    on-device label outcomes in the window (a handful of gate samples
    cannot audit an accuracy contract); the latency/deadline verdicts
    need ``min_requests`` resolved completions."""

    p99_ms: Optional[float] = None
    deadline_miss_rate: Optional[float] = None
    reliability_gap: Optional[float] = None
    reliability_shortfall: Optional[float] = None
    #: calibration-health SLOs (streaming reliability-sketch gauges):
    #: ``ece_cap`` caps the windowed expected calibration error;
    #: ``coverage_floor`` is a FLOOR -- the on-device precision (share of
    #: kept answers that were correct) dropping BELOW it trips.
    ece_cap: Optional[float] = None
    coverage_floor: Optional[float] = None
    min_requests: int = 20  # fewer resolved completions -> no verdict
    min_gate_samples: Optional[int] = None  # default: min_requests

    def __post_init__(self):
        if all(_slo_threshold(self, m) is None for m in QOS_METRICS):
            raise ValueError("an SLO must watch at least one metric")
        if self.min_requests < 1:
            raise ValueError("min_requests must be >= 1")
        if self.min_gate_samples is not None and self.min_gate_samples < 1:
            raise ValueError("min_gate_samples must be >= 1")


@dataclass(frozen=True)
class QoSConfig:
    window_s: float = 2.0  # trailing evidence window per check
    trip_after: int = 2  # consecutive violating windows before a trip
    clear_after: int = 4  # consecutive clean windows before a clear

    def __post_init__(self):
        if self.window_s <= 0:
            raise ValueError("window_s must be positive")
        if self.trip_after < 1 or self.clear_after < 1:
            raise ValueError("trip_after/clear_after must be >= 1")


class QoSMonitor:
    """Trip/clear state machine per cell. `reset(n_cells)` arms it for a
    run (the Orchestrator calls it on attach); `observe(tel, now)` is one
    evaluation pass over every watched cell."""

    def __init__(
        self,
        slo: CellSLO,
        config: Optional[QoSConfig] = None,
        cells: Optional[Sequence[int]] = None,
    ):
        self.slo = slo
        self.config = config or QoSConfig()
        #: None = watch every cell; otherwise the watched subset
        self.cells = None if cells is None else tuple(int(c) for c in cells)
        self.reset(0)

    def reset(self, n_cells: int) -> None:
        self._n = n_cells
        self._bad = np.zeros(n_cells, np.int64)
        self._good = np.zeros(n_cells, np.int64)
        self._tripped = np.zeros(n_cells, bool)
        self.trip_log: List[Tuple[float, int, str]] = []
        self.clear_log: List[Tuple[float, int]] = []

    # ------------------------------------------------------------- queries
    def is_tripped(self, cell: int) -> bool:
        return bool(self._tripped[cell])

    def tripped_cells(self) -> np.ndarray:
        return np.flatnonzero(self._tripped)

    def tripped_mask(self) -> np.ndarray:
        """Boolean per-cell trip state -- the distress signal the fleet
        controller consumes (`FleetController.update(distressed=...)`)."""
        return self._tripped.copy()

    def violation(self, qos: Dict[str, float]) -> Optional[str]:
        """One window's verdict: None = no verdict (no watched metric had
        enough evidence), '' = clean, otherwise the name of the first
        violated metric. Each metric is judged only when its OWN evidence
        suffices -- completions for the latency/deadline SLOs, on-device
        gate samples for the reliability ones."""
        slo = self.slo
        min_gate = (
            slo.min_requests
            if slo.min_gate_samples is None
            else slo.min_gate_samples
        )
        judged = False
        for metric in QOS_METRICS:
            cap = _slo_threshold(slo, metric)
            if cap is None:
                continue
            if metric in _GATE_METRICS:
                if qos.get("gate_samples", 0) < min_gate:
                    continue
            elif metric in _CAL_METRICS:
                if qos.get("cal_samples", 0) < min_gate:
                    continue
            elif qos["requests"] < slo.min_requests:
                continue
            judged = True
            v = qos[metric]
            if not np.isfinite(v):
                continue
            bad = v < cap if metric in _LOWER_IS_BAD else v > cap
            if bad:
                return metric
        return "" if judged else None

    # ------------------------------------------------------------- observe
    def observe(self, tel, now: float) -> Dict[str, list]:
        """Evaluate every watched cell's trailing window at `now` ->
        {"tripped": [(cell, metric), ...], "cleared": [cell, ...],
        "evidence": {cell: {...}}} for the transitions THIS pass caused
        (already-tripped cells staying bad report nothing). `evidence`
        carries, per transitioning cell, the windowed metric value, the
        SLO cap, and the streak that crossed the hysteresis threshold --
        the audit trail a trip must be reconstructible from."""
        watch = range(self._n) if self.cells is None else self.cells
        tripped: List[Tuple[int, str]] = []
        cleared: List[int] = []
        evidence: Dict[int, Dict] = {}
        for c in watch:
            qos = tel.cell_qos_estimate(c, self.config.window_s, now)
            verdict = self.violation(qos)
            if verdict is None:
                continue
            if verdict:
                self._bad[c] += 1
                self._good[c] = 0
                if not self._tripped[c] and self._bad[c] >= self.config.trip_after:
                    self._tripped[c] = True
                    tripped.append((c, verdict))
                    self.trip_log.append((now, c, verdict))
                    ev = {
                        "metric": verdict,
                        "value": float(qos[verdict]),
                        "cap": float(_slo_threshold(self.slo, verdict)),
                        "op": "<" if verdict in _LOWER_IS_BAD else ">",
                        "bad_streak": int(self._bad[c]),
                        "requests": int(qos["requests"]),
                        "gate_samples": int(qos["gate_samples"]),
                    }
                    if verdict in _CAL_METRICS:
                        ev["cal_samples"] = int(qos.get("cal_samples", 0))
                        bins = qos.get("cal_bins") or []
                        # the offending bins: largest count-weighted
                        # conf-vs-acc residuals, the reliability-diagram
                        # evidence an operator reconstructs the trip from
                        ev["bins"] = sorted(
                            bins,
                            key=lambda b: -b["count"] * abs(b["residual"]),
                        )[:3]
                    evidence[c] = ev
            else:
                self._good[c] += 1
                self._bad[c] = 0
                if self._tripped[c] and self._good[c] >= self.config.clear_after:
                    self._tripped[c] = False
                    cleared.append(c)
                    self.clear_log.append((now, c))
                    evidence[c] = {"good_streak": int(self._good[c])}
        return {"tripped": tripped, "cleared": cleared, "evidence": evidence}
