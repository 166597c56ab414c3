"""Columnar telemetry for fleet-scale runs.

At 100k+ requests, one `RequestRecord` object per request is the
bottleneck, so the fleet stores per-cell *columns* (numpy arrays appended
once per window) and computes the same metrics the event-driven
`Telemetry` defines -- p50/p95/p99 latency, deadline-miss rate, offload
rate, accuracy, and the on-device-weighted miscalibration gap -- through
the shared control-plane primitives in `repro_torch.core.control`
(`latency_stats_ms`, `on_device_gap`, and the windowed
`windowed_mean`/`windowed_rate`/`windowed_mix` estimators), so the two
simulators can never disagree about what a metric or a controller-facing
estimate means.

Reports come at three altitudes: `cell_summary(c)` (one cell),
`fleet_summary()` (every request in one pool, gap still aggregated
per-(cell, context) regime so opposite-sign regimes cannot cancel), and
`per_cell_summary()` (the fleet operator's table).

Port of `repro.fleet.telemetry`: host numpy, the reference's arithmetic
on the same columns, so the same decisions give the same summaries.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.bank import UNKNOWN_CONTEXT
from repro_torch.core.control import (
    latency_stats_ms,
    on_device_gap,
    windowed_mean,
    windowed_mix,
    windowed_rate,
)
from repro_torch.obs.calibration import (
    bin_block,
    block_coverage,
    block_ece,
    block_reliability,
)


class _Observations:
    """Append-only (t, value) stream in amortized growing buffers, so a
    controller windowing it every tick reads a zero-copy view instead of
    re-concatenating the full chunk history each tick. (Times are NOT
    globally sorted -- a congested cell emits future-dated transfer
    observations -- so reads mask the whole view; that is a cheap
    vectorized scan, the churn was the per-tick reallocation.)"""

    def __init__(self, dtype):
        self._t = np.empty(64, np.float64)
        self._v = np.empty(64, dtype)
        self._n = 0

    def append(self, times, values) -> None:
        times = np.asarray(times, np.float64)
        k = times.shape[0]
        while self._n + k > self._t.shape[0]:
            self._t = np.concatenate([self._t, np.empty_like(self._t)])
            self._v = np.concatenate([self._v, np.empty_like(self._v)])
        self._t[self._n:self._n + k] = times
        self._v[self._n:self._n + k] = values
        self._n += k

    @property
    def empty(self) -> bool:
        return self._n == 0

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._t[:self._n], self._v[:self._n]


class _CellColumns:
    """Append-only per-cell columns; concatenated lazily on first read."""

    FIELDS = ("latency_s", "on_device", "correct", "p_tar", "branch",
              "ctx_id", "est_id", "missed", "energy_j")

    def __init__(self):
        self.chunks: Dict[str, List[np.ndarray]] = {f: [] for f in self.FIELDS}
        self._cache: Optional[Dict[str, np.ndarray]] = None

    def append(self, **cols: np.ndarray) -> None:
        if set(cols) != set(self.FIELDS):
            missing = set(self.FIELDS) ^ set(cols)
            raise ValueError(f"window columns mismatch: {sorted(missing)}")
        n = len(cols["latency_s"])
        for f, v in cols.items():
            v = np.asarray(v)
            if v.shape != (n,):
                raise ValueError(f"column {f!r} has shape {v.shape}, want ({n},)")
            self.chunks[f].append(v)
        self._cache = None

    def column(self, name: str) -> np.ndarray:
        if self._cache is None:
            self._cache = {
                f: (np.concatenate(c) if c else np.empty(0))
                for f, c in self.chunks.items()
            }
        return self._cache[name]

    def __len__(self) -> int:
        return int(self.column("latency_s").shape[0])


class FleetTelemetry:
    """Fleet-wide roll-ups + the windowed per-cell estimates the fleet
    controller consumes (observed uplink rates, arrival counts)."""

    def __init__(self, n_cells: int, context_keys: List[str],
                 bank_keys: Optional[List[str]] = None):
        self.n_cells = n_cells
        self.context_keys = list(context_keys)
        self.bank_keys = None if bank_keys is None else list(bank_keys)
        self._cells = [_CellColumns() for _ in range(n_cells)]
        # (t, rate) observations per cell, one per uplink transfer
        self._bw = [_Observations(np.float64) for _ in range(n_cells)]
        # (t, context id) observations per cell, one per gated request --
        # the edge-side context verdicts a context-aware controller windows
        self._ctx = [_Observations(np.int64) for _ in range(n_cells)]
        self._arrivals: List[np.ndarray] = [np.empty(0)] * n_cells
        # (t, cell, branch, p_tar, compression_level) per adopted switch
        self.controller_events: List[Tuple[float, int, int, float, int]] = []
        # live QoS streams (orchestrated runs only): per-cell lockstep
        # (t, latency) + (t, missed) and (t, correct) + (t, p_tar) pairs,
        # fed from resolved completions DURING the run so a QoS monitor
        # can window per-cell tails mid-simulation. Times are completion
        # times; attribution follows the ORIGIN cell under load shedding.
        self._live_lat = [_Observations(np.float64) for _ in range(n_cells)]
        self._live_miss = [_Observations(np.int8) for _ in range(n_cells)]
        self._live_cor = [_Observations(np.int8) for _ in range(n_cells)]
        self._live_pt = [_Observations(np.float64) for _ in range(n_cells)]
        # live calibration streams: (t, gate confidence) + lockstep
        # (t, edge correctness) + (t, kept on-device) for EVERY gated
        # request (offloaded ones included -- the reliability diagram is
        # about the gate's confidence, not about who answered), fed at
        # edge-completion time so the QoS monitor can window ECE /
        # coverage mid-run
        self._live_conf = [_Observations(np.float64) for _ in range(n_cells)]
        self._live_ccor = [_Observations(np.int8) for _ in range(n_cells)]
        self._live_con = [_Observations(np.int8) for _ in range(n_cells)]
        # arrivals a cell serves on BEHALF of dead neighbors (load shedding)
        # -- folded into its arrival-rate estimate so a utilization-aware
        # controller prices the host cell's true demand
        self._shed_arr = [_Observations(np.int8) for _ in range(n_cells)]
        #: (t, kind, payload) orchestration audit log -- churn flips, QoS
        #: trips/clears, rollout transitions -- in event order
        self.orchestration_events: List[Tuple[float, str, Dict]] = []

    # ------------------------------------------------------------- ingest
    def set_arrivals(self, cell: int, arrival_s: np.ndarray) -> None:
        self._arrivals[cell] = np.asarray(arrival_s, np.float64)

    def add_window(self, cell: int, **cols: np.ndarray) -> None:
        self._cells[cell].append(**cols)

    def observe_bandwidth(self, cell: int, times: np.ndarray, rates: np.ndarray) -> None:
        self._bw[cell].append(times, rates)

    def observe_contexts(self, cell: int, times: np.ndarray, ctx_ids: np.ndarray) -> None:
        """Per-request context verdicts (indices into `context_keys`, -1 =
        unrecognized) at gate time -- estimator verdicts on the honest
        path, true contexts in oracle mode."""
        self._ctx[cell].append(times, ctx_ids)

    def record_controller(
        self, t: float, cell: int, branch: int, p_tar: float, level: int = 0
    ) -> None:
        self.controller_events.append((t, cell, branch, p_tar, int(level)))

    def observe_live_latency(
        self, cell: int, times: np.ndarray, latency_s: np.ndarray,
        missed: np.ndarray,
    ) -> None:
        """Resolved completions as they happen (missed: 1/0, -1 = no
        deadline declared). Edge completions land exactly; offloaded ones
        stream through the simulator's live cloud view."""
        self._live_lat[cell].append(times, latency_s)
        self._live_miss[cell].append(times, missed)

    def observe_live_gate(
        self, cell: int, times: np.ndarray, correct: np.ndarray,
        p_tar: np.ndarray,
    ) -> None:
        """Label outcomes of ON-DEVICE answers as they resolve -- the
        stream the reliability-gap SLO is audited against."""
        self._live_cor[cell].append(times, correct)
        self._live_pt[cell].append(times, p_tar)

    def observe_live_calibration(
        self, cell: int, times: np.ndarray, conf: np.ndarray,
        correct: np.ndarray, on: np.ndarray,
    ) -> None:
        """Gate confidences + EDGE correctness + on-device flags of every
        gated request as its edge pass resolves -- the stream the
        calibration SLOs (`ece_cap` / `coverage_floor`) window."""
        self._live_conf[cell].append(times, conf)
        self._live_ccor[cell].append(times, correct)
        self._live_con[cell].append(times, on)

    def record_orchestration(self, t: float, kind: str, **payload) -> None:
        self.orchestration_events.append((float(t), str(kind), dict(payload)))

    def observe_shed_arrivals(self, cell: int, times: np.ndarray) -> None:
        """Arrivals shed TO `cell` from a dead neighbor; they join the
        host's arrival-rate estimate (not its latency columns -- those
        stay with the origin)."""
        self._shed_arr[cell].append(times, np.zeros(len(times), np.int8))

    def cell_qos_estimate(
        self, cell: int, window_s: float, now: float
    ) -> Dict[str, float]:
        """Trailing-window QoS as the monitor sees it: p99 latency,
        deadline-miss rate, on-device reliability gap, and how many
        completions the window holds. NaN where the window has no
        evidence for a metric (the monitor treats NaN as 'no verdict')."""
        out = {"requests": 0, "gate_samples": 0, "cal_samples": 0,
               "p99_ms": float("nan"),
               "deadline_miss_rate": float("nan"),
               "reliability_gap": float("nan"),
               "reliability_shortfall": float("nan"),
               "ece": float("nan"), "coverage": float("nan"),
               "cal_bins": None}
        if not self._live_lat[cell].empty:
            t, lat = self._live_lat[cell].arrays()
            m = (t > now - window_s) & (t <= now)
            out["requests"] = int(m.sum())
            if m.any():
                out["p99_ms"] = float(np.quantile(lat[m], 0.99) * 1000.0)
                _, miss = self._live_miss[cell].arrays()
                mm = m & (miss >= 0)
                if mm.any():
                    out["deadline_miss_rate"] = float(miss[mm].mean())
        if not self._live_cor[cell].empty:
            t, cor = self._live_cor[cell].arrays()
            _, pt = self._live_pt[cell].arrays()
            m = (t > now - window_s) & (t <= now)
            out["gate_samples"] = int(m.sum())
            if m.any():
                gap = on_device_gap(cor[m], pt[m])
                if gap is not None:
                    out["reliability_gap"] = gap
                # the SLO-facing direction: how far BELOW the promised
                # target the on-device accuracy fell (over-delivery is 0)
                out["reliability_shortfall"] = float(
                    max(0.0, pt[m].mean() - cor[m].mean())
                )
        if not self._live_conf[cell].empty:
            t, conf = self._live_conf[cell].arrays()
            _, ccor = self._live_ccor[cell].arrays()
            _, con = self._live_con[cell].arrays()
            m = (t > now - window_s) & (t <= now)
            out["cal_samples"] = int(m.sum())
            if m.any():
                # the sketch's binning math, shared so the windowed gauge
                # and the end-of-run sketch can never disagree
                blk = bin_block(conf[m], ccor[m], con[m])
                out["ece"] = block_ece(blk)
                out["coverage"] = block_coverage(blk)
                out["cal_bins"] = block_reliability(blk)
        return out

    # --------------------------------------------------- controller window
    def bandwidth_estimate(
        self, cell: int, window_s: float, now: float
    ) -> Optional[float]:
        """Mean observed uplink rate over the trailing window; stale most
        recent sample if the window is empty (the `Telemetry` contract);
        None when the cell never transferred."""
        if self._bw[cell].empty:
            return None
        t, v = self._bw[cell].arrays()
        return windowed_mean(t, v, window_s, now, stale_fallback=True)

    def context_mix_estimate(
        self, cell: int, window_s: float, now: float
    ) -> Optional[np.ndarray]:
        """Share of the cell's trailing-window traffic per context key ->
        (len(context_keys),) weights summing to 1, or None when nothing
        (recognizable) was observed. Unrecognized (-1) verdicts are
        excluded: the bank serves them with the default plan, but their
        gate statistics belong to no fitted context."""
        if self._ctx[cell].empty:
            return None
        t, v = self._ctx[cell].arrays()
        return windowed_mix(t, v, len(self.context_keys), window_s, now)

    def arrival_rate_estimate(
        self, cell: int, window_s: float, now: float
    ) -> Optional[float]:
        base = windowed_rate(self._arrivals[cell], window_s, now)
        if self._shed_arr[cell].empty:
            return base
        t, _ = self._shed_arr[cell].arrays()
        shed = float(((t > now - window_s) & (t <= now)).sum()) / window_s
        if base is None:
            return shed if shed > 0 else None
        return base + shed

    # ------------------------------------------------------------ reports
    def requests(self, cell: Optional[int] = None) -> int:
        cells = self._cells if cell is None else [self._cells[cell]]
        return sum(len(c) for c in cells)

    def _gap_groups(self, cells) -> Tuple[List[float], List[int]]:
        """Per-(cell, context) on-device reliability gaps + weights. The
        regime is (cell, context): two cells in the same context are
        separate reliability contracts, exactly as two contexts in one
        cell are."""
        gaps, weights = [], []
        for c in cells:
            on = c.column("on_device")
            correct = c.column("correct")
            p_tar = c.column("p_tar")
            ctx = c.column("ctx_id")
            known = on & (correct >= 0)
            for cid in np.unique(ctx[known]):
                m = known & (ctx == cid)
                gap = on_device_gap(correct[m], p_tar[m])
                if gap is not None:
                    gaps.append(gap)
                    weights.append(int(m.sum()))
        return gaps, weights

    def _summary_of(self, cells) -> Dict[str, float]:
        lat = np.concatenate([c.column("latency_s") for c in cells]) \
            if cells else np.empty(0)
        out = latency_stats_ms(lat)
        out["requests"] = int(lat.shape[0])
        if lat.shape[0] == 0:
            nan = float("nan")
            out.update(offload_rate=nan, deadline_miss_rate=nan, accuracy=nan,
                       miscalibration_gap=nan, energy_j_total=0.0)
            return out
        out["energy_j_total"] = float(
            sum(c.column("energy_j").sum() for c in cells)
        )
        on = np.concatenate([c.column("on_device") for c in cells])
        correct = np.concatenate([c.column("correct") for c in cells])
        missed = np.concatenate([c.column("missed") for c in cells])
        out["offload_rate"] = float((~on).mean())
        known = correct >= 0  # correct is -1 when labels are unknown
        out["accuracy"] = float(correct[known].mean()) if known.any() else float("nan")
        has_deadline = missed >= 0
        out["deadline_miss_rate"] = (
            float(missed[has_deadline].mean()) if has_deadline.any() else float("nan")
        )
        gaps, weights = self._gap_groups(cells)
        out["miscalibration_gap"] = (
            float(np.average(gaps, weights=weights)) if gaps else float("nan")
        )
        return out

    def cell_summary(self, cell: int) -> Dict[str, float]:
        return self._summary_of([self._cells[cell]])

    def fleet_summary(self) -> Dict[str, float]:
        s = self._summary_of(self._cells)
        s["cells"] = self.n_cells
        s["controller_switches"] = len(self.controller_events)
        return s

    def per_cell_summary(self) -> List[Dict[str, float]]:
        return [self.cell_summary(c) for c in range(self.n_cells)]

    def per_context_summary(self) -> Dict[str, Dict[str, float]]:
        """Fleet-wide per-TRUE-context roll-up (the `Telemetry` analogue):
        request count, offload rate, accuracy, miscalibration gap, and how
        often the estimator named the context correctly."""
        out: Dict[str, Dict[str, float]] = {}
        for cid, key in enumerate(self.context_keys):
            lat_n, on_l, cor_l, pt_l, est_l = 0, [], [], [], []
            for c in self._cells:
                m = c.column("ctx_id") == cid
                if not m.any():
                    continue
                lat_n += int(m.sum())
                on_l.append(c.column("on_device")[m])
                cor_l.append(c.column("correct")[m])
                pt_l.append(c.column("p_tar")[m])
                est_l.append(c.column("est_id")[m])
            if lat_n == 0:
                continue
            on = np.concatenate(on_l)
            correct = np.concatenate(cor_l)
            p_tar = np.concatenate(pt_l)
            est = np.concatenate(est_l)
            known = correct >= 0
            on_known = on & known
            gap = on_device_gap(correct[on_known], p_tar[on_known]) \
                if on_known.any() else None
            # est ids: >=0 index bank_keys, -1 = unknown verdict, -2 = no
            # estimator ran (oracle/single-plan selection)
            match = float("nan")
            ran = est > -2
            if self.bank_keys is not None and ran.any():
                names = np.asarray(self.bank_keys + [UNKNOWN_CONTEXT])
                got = names[est[ran]]  # -1 wraps onto the sentinel
                match = float((got == key).mean())
            out[key] = {
                "requests": lat_n,
                "offload_rate": float((~on).mean()),
                "accuracy": float(correct[known].mean()) if known.any() else float("nan"),
                "on_device_accuracy": (
                    float(correct[on_known].mean()) if on_known.any() else float("nan")
                ),
                "miscalibration_gap": float("nan") if gap is None else gap,
                "est_match_rate": match,
            }
        return out
