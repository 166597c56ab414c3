"""Per-request bookkeeping for the serving runtime.

Port of `repro.serving.telemetry` (host Python and numpy).

`Telemetry` collects one `RequestRecord` per served request plus timestamped
observations of uplink bandwidth, queue depth, gate-time context verdicts,
and controller decisions. It answers both the reporting questions
(p50/p95/p99 latency, deadline-miss rate, offload rate, accuracy,
throughput) and the control questions (what did the link/queues/traffic
mix look like over the last window) -- the latter is what
`OnlineController` consumes.

The metric and estimator definitions live in `repro_torch.core.control`
(`latency_stats_ms`, `on_device_gap`, `windowed_mean`/`windowed_rate`/
`windowed_mix`) and are shared with `repro_torch.fleet.telemetry`, so the two
stacks cannot disagree about what a number means; they are re-exported
here for the long-standing import sites.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.control import (  # noqa: F401  (shared, re-exported)
    latency_stats_ms,
    on_device_gap,
    windowed_mean,
    windowed_mix,
    windowed_rate,
)


@dataclass
class RequestRecord:
    req_id: int
    arrival_s: float
    device: int
    branch: int  # physical branch deployed when the request was gated
    p_tar: float  # effective target in force when the request was gated
    on_device: bool
    edge_start_s: float
    edge_done_s: float
    complete_s: float
    correct: Optional[bool] = None  # None when the core has no labels
    deadline_s: Optional[float] = None
    context: Optional[str] = None  # true distortion context at gate time
    est_context: Optional[str] = None  # edge-side estimator's verdict
    # edge-side energy (compute J + radio J for the shipped payload; see
    # `repro_torch.offload.latency.energy_per_request_j`); None on legacy paths
    energy_j: Optional[float] = None

    @property
    def latency_s(self) -> float:
        return self.complete_s - self.arrival_s

    @property
    def edge_wait_s(self) -> float:
        """Time spent queued for the edge device (batching/uplink/cloud
        contention show up in latency_s, not here)."""
        return self.edge_start_s - self.arrival_s

    @property
    def missed_deadline(self) -> Optional[bool]:
        if self.deadline_s is None:
            return None
        return self.latency_s > self.deadline_s


class Telemetry:
    def __init__(self):
        self.records: List[RequestRecord] = []
        self.arrival_times: List[float] = []
        self.bandwidth_samples: List[Tuple[float, float]] = []  # (t, bps)
        self.queue_samples: List[Tuple[float, float]] = []  # (t, mean per-device depth)
        self.context_samples: List[Tuple[float, str]] = []  # (t, context key)
        # (t, branch, p_tar, compression_level) per adopted switch
        self.controller_events: List[Tuple[float, int, float, int]] = []

    # ------------------------------------------------------------ ingest
    def add(self, record: RequestRecord) -> None:
        self.records.append(record)

    def observe_arrival(self, t: float) -> None:
        self.arrival_times.append(t)

    def observe_bandwidth(self, t: float, bps: float) -> None:
        self.bandwidth_samples.append((t, bps))

    def observe_queue(self, t: float, depth: int) -> None:
        self.queue_samples.append((t, depth))

    def observe_context(self, t: float, context: str) -> None:
        """The edge-side context verdict at gate time (the estimator's
        when one ran, else the true context) -- what a context-aware
        controller windows into a traffic-mix estimate."""
        self.context_samples.append((t, context))

    def record_controller(
        self, t: float, branch: int, p_tar: float, level: int = 0
    ) -> None:
        self.controller_events.append((t, branch, p_tar, int(level)))

    # ----------------------------------------------------------- reports
    def latencies(self) -> np.ndarray:
        return np.asarray([r.latency_s for r in self.records], np.float64)

    def percentile(self, q: float) -> float:
        lat = self.latencies()
        return float(np.percentile(lat, q)) if lat.size else float("nan")

    @property
    def p50_s(self) -> float:
        return self.percentile(50)

    @property
    def p95_s(self) -> float:
        return self.percentile(95)

    @property
    def p99_s(self) -> float:
        return self.percentile(99)

    @property
    def offload_rate(self) -> float:
        if not self.records:
            return float("nan")
        return float(np.mean([not r.on_device for r in self.records]))

    @property
    def deadline_miss_rate(self) -> float:
        misses = [r.missed_deadline for r in self.records if r.missed_deadline is not None]
        return float(np.mean(misses)) if misses else float("nan")

    @property
    def accuracy(self) -> float:
        known = [r.correct for r in self.records if r.correct is not None]
        return float(np.mean(known)) if known else float("nan")

    @property
    def energy_j_total(self) -> float:
        """Total edge-side energy over records that carry it (0.0 when no
        path stamped energy -- legacy simulators)."""
        return float(sum(r.energy_j for r in self.records
                         if r.energy_j is not None))

    @property
    def mean_queue_depth(self) -> float:
        if not self.queue_samples:
            return float("nan")
        return float(np.mean([d for _, d in self.queue_samples]))

    @property
    def throughput_rps(self) -> float:
        if len(self.records) < 2:
            return float("nan")
        t0 = min(r.arrival_s for r in self.records)
        t1 = max(r.complete_s for r in self.records)
        return len(self.records) / max(t1 - t0, 1e-12)

    # -------------------------------------------------- per-context reports
    def _context_groups(self) -> Dict[str, List[RequestRecord]]:
        """Records grouped by TRUE context; contextless records (plain
        LogitsCore/EngineCore runs) all land in one "__all__" group, so the
        same metrics work with and without drift."""
        groups: Dict[str, List[RequestRecord]] = {}
        for r in self.records:
            groups.setdefault(r.context or "__all__", []).append(r)
        return groups

    @staticmethod
    def _gap(records: List[RequestRecord]) -> Optional[float]:
        """One group's reliability gap (see `on_device_gap`)."""
        on_dev = [r for r in records if r.on_device and r.correct is not None]
        if not on_dev:
            return None
        return on_device_gap(
            np.asarray([r.correct for r in on_dev]),
            np.asarray([r.p_tar for r in on_dev]),
        )

    def per_context_summary(self) -> Dict[str, Dict[str, float]]:
        """Per true-context roll-up: request count, offload rate, end-to-end
        accuracy, on-device accuracy, miscalibration gap, and how often the
        edge-side estimator named the context correctly."""
        out: Dict[str, Dict[str, float]] = {}
        for ctx, recs in sorted(self._context_groups().items()):
            on_dev = [r for r in recs if r.on_device and r.correct is not None]
            known = [r.correct for r in recs if r.correct is not None]
            est = [r for r in recs if r.est_context is not None]
            gap = self._gap(recs)
            out[ctx] = {
                "requests": len(recs),
                "offload_rate": float(np.mean([not r.on_device for r in recs])),
                "accuracy": float(np.mean(known)) if known else float("nan"),
                "on_device_accuracy": (
                    float(np.mean([r.correct for r in on_dev]))
                    if on_dev else float("nan")
                ),
                "miscalibration_gap": float("nan") if gap is None else gap,
                "est_match_rate": (
                    float(np.mean([r.est_context == r.context for r in est]))
                    if est else float("nan")
                ),
            }
        return out

    def miscalibration_gap(self) -> float:
        """On-device-count-weighted mean of per-context |on-device accuracy
        - p_tar|. Aggregating |gap| per regime and then averaging is the
        honest number under drift: a +5pp regime and a -5pp regime do NOT
        cancel into "calibrated"."""
        gaps, weights = [], []
        for recs in self._context_groups().values():
            gap = self._gap(recs)
            if gap is None:
                continue
            gaps.append(gap)
            weights.append(sum(1 for r in recs if r.on_device))
        if not gaps:
            return float("nan")
        return float(np.average(gaps, weights=weights))

    # ----------------------------------------------- controller's window
    def bandwidth_estimate(
        self, window_s: Optional[float] = None, now: Optional[float] = None
    ) -> Optional[float]:
        """Mean observed uplink rate over the trailing window. If the window
        holds no transfer but older observations exist, the most recent one
        is returned (stale beats assuming the nominal best-case link); None
        only when nothing was ever observed."""
        t = [t for t, _ in self.bandwidth_samples]
        v = [b for _, b in self.bandwidth_samples]
        return windowed_mean(t, v, window_s, now, stale_fallback=True)

    def queue_estimate(
        self, window_s: Optional[float] = None, now: Optional[float] = None
    ) -> Optional[float]:
        t = [t for t, _ in self.queue_samples]
        v = [d for _, d in self.queue_samples]
        return windowed_mean(t, v, window_s, now, stale_fallback=False)

    def arrival_rate_estimate(
        self, window_s: float, now: float
    ) -> Optional[float]:
        """Fleet-wide arrivals/second over the trailing window (None if no
        arrival landed in it). A simulation younger than the window divides
        by the elapsed time instead, so early estimates aren't biased low."""
        return windowed_rate(self.arrival_times, window_s, now)

    def context_mix_estimate(
        self, window_s: float, now: float
    ) -> Optional[Dict[str, float]]:
        """Share of the trailing window's gated traffic per context key
        ({context: share} summing to 1), from the gate-time verdicts
        `observe_context` recorded; None when nothing (recognizable) was
        observed. `UNKNOWN_CONTEXT` verdicts are excluded: the bank
        serves them with the default plan, but their gate statistics
        belong to no fitted context."""
        from repro_torch.core.bank import UNKNOWN_CONTEXT

        if not self.context_samples:
            return None
        keys = sorted(
            {c for _, c in self.context_samples if c != UNKNOWN_CONTEXT}
        )
        if not keys:
            return None
        index = {k: i for i, k in enumerate(keys)}
        t = [t for t, c in self.context_samples]
        ids = [index.get(c, -1) for _, c in self.context_samples]
        mix = windowed_mix(t, ids, len(keys), window_s, now)
        if mix is None:
            return None
        return {k: float(m) for k, m in zip(keys, mix)}

    # ----------------------------------------------------------- summary
    def summary(self) -> Dict[str, float]:
        """Machine-readable (JSON-safe) roll-up of the run."""
        return {
            "requests": len(self.records),
            "p50_ms": self.p50_s * 1e3,
            "p95_ms": self.p95_s * 1e3,
            "p99_ms": self.p99_s * 1e3,
            "mean_ms": float(self.latencies().mean() * 1e3) if self.records else float("nan"),
            "offload_rate": self.offload_rate,
            "deadline_miss_rate": self.deadline_miss_rate,
            "accuracy": self.accuracy,
            "mean_queue_depth": self.mean_queue_depth,
            "throughput_rps": self.throughput_rps,
            "controller_switches": len(self.controller_events),
            "miscalibration_gap": self.miscalibration_gap(),
            "energy_j_total": self.energy_j_total,
        }
