"""Time-stepped, vectorized fleet simulator.

Instead of one heap event per arrival/gate/transfer, requests move
through the tiers as whole *arrival windows* of numpy columns:

    per cell:  arrivals in [t0, t1)  ->  per-device FIFO edge service
               -> batched gate (GateTable through the selected backend)
               -> per-cell shared-uplink FIFO
    fleet:     all cells' transfers -> ONE cloud tier (K parallel servers)

Every queue is a deterministic-service FIFO, which admits an exact O(n)
vectorized solve: for done_i = max(t_i, done_{i-1}) + s_i, substituting
g_i = done_i - cumsum(s)_i turns the recurrence into a running maximum
(`np.maximum.accumulate`) -- no Python loop per request. The cloud's K
parallel servers decompose into K independent such chains (job i waits
for job i-K when service is deterministic); the cloud is solved once,
globally sorted by transfer completion, after the windowed loop (see
`_CloudJobs` for why that ordering is the correct one).

Exactness: in the single-cell, single-device, fixed-link, per-sample
case the windowed pipeline IS the event simulator -- same gate values
(shared `gate_statistics` math), same FIFO algebra -- and
`tests/test_torch_fleet.py` pins equality to float round-off, queues empty or
not. The windowed semantics differ from the event heap only where
documented: (1) deployed (branch, p_tar) changes at window boundaries
and applies per ARRIVAL window (the event runtime captures config at
edge-service start); (2) a multi-device cell enqueues window w's uplink
transfers before window w+1's even if an idle device finished a later
arrival earlier; (3) time-varying links price a transfer at its start
time via one fixed-point repricing pass (exact for piecewise-constant
links whose state doesn't change between the two passes, and always
exact for fixed links); (4) offloads ship per sample (no microbatcher).

Orchestration hooks (`repro_torch.orchestration` drives them; all default off,
and the default path is operation-for-operation the pre-orchestration
simulator): an `orchestrator` object is called once per window boundary
and may flip per-cell ACTIVATION (a dead cell's window arrivals are shed
to the nearest live ring neighbor -- served on that cell's devices,
uplink, deployed state, and gate table, with the ORIGIN cell's context
regime -- or, with no live neighbor, shipped whole-window to the shared
cloud over a nominal-rate backhaul), swap per-cell GATE TABLES (canary /
fleet-wide rollout of a new `PlanBank`; candidate tables must serve the
same contexts, samples, and branches as the incumbent), and declare
CLOUD SLOWDOWN intervals (brownouts: cloud service time scaled for jobs
whose transfer completes inside the interval). Shed service runs
shed-batch-after-(or before)-own-batch within a window, the same batch
ordering approximation as (2). While an orchestrator is attached the
simulator also maintains a LIVE completion view (edge completions exact;
offloaded completions streamed through an incremental copy of the cloud
solve, equal to the final deferred solve up to chunked-cumsum round-off)
so a QoS monitor can watch per-cell tails mid-run; final telemetry still
comes from the exact deferred solve.

Port of `repro.fleet.simulator`. The pipeline stays host numpy, as in the
reference: every queue is an O(window) numpy block. The gate goes through
the table's `GateBackend`: under ``"torch"`` each (cell, window) lookup is
a gather from the card-resident (context, branch, sample) tables (the
tables themselves are K1 launches at construction), and `cloud_pred` at a
non-zero codec level round-trips the final logits through K3/K4 on the
card once per (table, level).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core.gatepath import GateTable
from repro_torch.fleet.telemetry import FleetTelemetry
from repro_torch.fleet.topology import FleetTopology
from repro_torch.kernels.compress import scaled_payload_nbytes
from repro_torch.models.convnet import payload_bytes
from repro_torch.obs import (
    build_spans,
    export_calibration,
    fleet_metrics,
    request_record,
)
from repro_torch.offload import latency as L


def fifo_done(t: np.ndarray, service: np.ndarray, free_s: float) -> np.ndarray:
    """Completion times of a FIFO single-server queue, vectorized.

    t: sorted job-ready times; service: per-job service times; free_s:
    when the server frees up from earlier work. Solves
    done_i = max(t_i, done_{i-1}) + s_i via cumsum + running max.
    """
    csum = np.cumsum(service)
    x = t - (csum - service)  # t_i - cumsum_{<i}
    if x.size:
        x[0] = max(x[0], free_s)
    return np.maximum.accumulate(x) + csum


@dataclass
class FleetConfig:
    window_s: float = 0.25  # arrival-window width (config switch granularity)
    #: ((start_s, end_s, factor), ...) cloud brownout intervals: a cloud job
    #: whose uplink transfer completes in [start, end) has its service time
    #: scaled by `factor` (capacity loss at the shared tier). Empty = the
    #: pre-orchestration behavior, bit for bit.
    cloud_slowdowns: Tuple[Tuple[float, float, float], ...] = ()


class _CloudJobs:
    """Every offloaded job of the whole run, as growing columns.

    The cloud tier is solved ONCE, after the windowed loop, over all jobs
    sorted by uplink-completion time. Processing it window-by-window would
    be wrong, not just inexact: a saturated cell's uplink emits transfers
    whose completion lies far in the future, and feeding those to the
    cloud in *generation* order would make jobs from healthy cells queue
    behind phantom busy servers. Nothing downstream of the cloud feeds
    back into the simulation, so deferring it is exact.
    """

    def __init__(self):
        self.t: List[np.ndarray] = []
        self.service: List[np.ndarray] = []
        self.win: List[np.ndarray] = []  # index into the window-cols list
        self.pos: List[np.ndarray] = []  # index into that window's arrays

    def add(self, t, service, win, pos):
        self.t.append(t)
        service = np.asarray(service, np.float64)
        self.service.append(
            np.full(len(t), service) if service.ndim == 0 else service
        )
        self.win.append(np.full(len(t), win, np.int64))
        self.pos.append(pos)


class _LiveCloud:
    """Streaming copy of the deferred cloud solve, for the QoS monitor.

    The deferred global solve is exact but only runs after the last
    window; a QoS monitor needs completions DURING the run. Any cloud job
    generated in window w has transfer-completion >= w's start, so at a
    boundary t0 every pending job with t < t0 is final: popping those in
    (stable) sorted order reproduces the deferred solve's global ordering
    batch by batch, and each of the K residue-class chains streams with a
    carried server-free time. Equal to the deferred solve up to chunked-
    cumsum round-off; never fed back into the final telemetry columns.
    """

    def __init__(self, k_servers: int):
        self.k = k_servers
        self._pend: List[np.ndarray] = []  # [t, service, cell, arrival, ded]
        self._free = np.zeros(k_servers)
        self._n_popped = 0

    def add(self, t, service, cell, arrival, deadline):
        ded = np.nan if deadline is None else float(deadline)
        self._pend.append(
            np.stack([
                t, np.broadcast_to(service, t.shape),
                np.full(len(t), cell, np.float64), arrival,
                np.full(len(t), ded),
            ])
        )

    def pop(self, now: float):
        """-> (cell, completion, latency, missed) for every pending job
        whose transfer completed before `now`."""
        if not self._pend:
            return None
        cols = np.concatenate(self._pend, axis=1)
        ready = cols[0] < now
        if not ready.any():
            return None
        keep = cols[:, ~ready]
        self._pend = [keep] if keep.shape[1] else []
        t, service, cell, arrival, ded = cols[:, ready]
        order = np.argsort(t, kind="stable")
        t, service = t[order], service[order]
        cell, arrival, ded = cell[order], arrival[order], ded[order]
        done = np.empty(len(t))
        idx = self._n_popped + np.arange(len(t))
        for r in range(self.k):
            m = idx % self.k == r
            if m.any():
                out = fifo_done(t[m], service[m], float(self._free[r]))
                done[m] = out
                self._free[r] = out[-1]
        self._n_popped += len(t)
        lat = done - arrival
        missed = np.where(np.isnan(ded), -1, (lat > ded).astype(np.int8))
        return cell.astype(np.int64), done, lat, missed.astype(np.int8)


class FleetSimulator:
    """Run a whole fleet topology through the windowed pipeline.

    table: the shared `GateTable` (all cells serve the same model and
    deployed plan/bank; per-cell state is (branch, p_tar), moved by the
    optional fleet controller). Each cell's `ContextSchedule` must visit
    only contexts the table covers; cells without a schedule serve the
    table's only context. The table's selected `GateBackend` decides how
    each window gates (host numpy fancy-indexing, or one gather from the
    card-resident tables under ``"torch"``).
    """

    def __init__(
        self,
        table: GateTable,
        topology: FleetTopology,
        profile: L.LatencyProfile,
        config: Optional[FleetConfig] = None,
        controller=None,
        payload_nbytes: Optional[Callable[[int], int]] = None,
        orchestrator=None,
        obs=None,
    ):
        self.table = table
        self.topology = topology
        self.profile = profile
        self.config = config or FleetConfig()
        self.orchestrator = orchestrator
        # observability (repro_torch.obs.Observability). Zero-perturbation:
        # the obs=None path adds no columns and runs no emission; pinned
        # bit-exactly by tests/test_torch_fleet.py. Trace emission is SAMPLED
        # (obs.trace_sample_every) and happens after the deferred cloud
        # solve, from the final patched columns.
        self.obs = obs
        self._tracing = obs is not None and obs.trace is not None
        self._metrics = None if obs is None else obs.metrics
        self._audit = None if obs is None else obs.audit
        # streaming reliability-bin sketch (repro_torch.obs.calibration),
        # accumulated columnarly per window at gate time, keyed by the
        # ORIGIN cell / active context / deployed branch
        self._cal = None if obs is None else getattr(obs, "calibration", None)
        if obs is not None and obs.audit is not None \
                and controller is not None and hasattr(controller, "audit"):
            controller.audit = obs.audit
        if self.config.window_s <= 0:
            raise ValueError("window_s must be positive")
        self.controller = controller
        if controller is not None:
            ratio = controller.interval_s / self.config.window_s
            if abs(ratio - round(ratio)) > 1e-9 or round(ratio) < 1:
                raise ValueError(
                    f"controller interval {controller.interval_s}s must be a "
                    f"positive multiple of window_s={self.config.window_s}s"
                )
            self._ticks_per_update = int(round(ratio))
            if not set(controller.branches) <= set(table.branches):
                raise ValueError(
                    f"controller may deploy branches {controller.branches} "
                    f"but the table only serves {table.branches}"
                )
        # the paper's model prices the payload unless the caller says otherwise
        self.payload_nbytes = payload_nbytes or payload_bytes

        plan = table.plan
        branch = plan.exit_index + 1
        if branch not in table.branches:
            raise ValueError(
                f"plan deploys branch {branch} but the table only serves "
                f"{table.branches}"
            )
        self._initial_state = (
            branch, float(plan.p_tar), int(getattr(plan, "compression_level", 0))
        )
        self._state: List[Tuple[int, float, int]] = []
        # estimator verdicts (bank key indices) -> table context ids, for
        # the context-mix telemetry the controller windows
        self._bank_to_table = np.asarray(
            [table.ctx_index.get(k, -1) for k in table.bank_keys] or [-1],
            np.int64,
        )

        # per-cell schedule-context -> table-context id mapping
        self._sched_map: List[Optional[np.ndarray]] = []
        self._static_ctx: List[int] = []
        for cell in topology.cells:
            if cell.schedule is None:
                if len(table.ctx_keys) != 1:
                    raise ValueError(
                        "cells without a schedule need a single-context "
                        f"table; this one covers {table.ctx_keys}"
                    )
                self._sched_map.append(None)
                self._static_ctx.append(0)
            else:
                missing = set(cell.schedule.contexts) - set(table.ctx_keys)
                if missing:
                    raise ValueError(
                        f"schedule visits contexts with no logits: "
                        f"{sorted(missing)}"
                    )
                self._sched_map.append(
                    np.asarray(
                        [table.ctx_index[k] for k in cell.schedule.contexts],
                        np.int64,
                    )
                )
                self._static_ctx.append(-1)
            if len(cell.workload) and int(cell.workload.sample.max()) >= table.n_samples:
                raise ValueError("workload samples exceed the gate table")

        # orchestration state (reset per run; see `run`)
        self._active = topology.initial_active_mask()
        self._cell_tables: List[Optional[GateTable]] = [None] * topology.n_cells
        self._backhaul_free = np.zeros(topology.n_cells)
        self._live: Optional[_LiveCloud] = None
        self.shed_counts = np.zeros(topology.n_cells, np.int64)

    # ------------------------------------------------- orchestration surface
    def set_active(self, cell: int, active: bool) -> None:
        """Flip a cell's activation (churn engine): an inactive cell's
        arrivals are shed to the nearest live ring neighbor (or the cloud
        backhaul) until it comes back."""
        self._active[cell] = bool(active)

    def active_mask(self) -> np.ndarray:
        return self._active.copy()

    def set_cell_table(self, cell: int, table: Optional[GateTable]) -> None:
        """Override one cell's gate table (canary / fleet-wide rollout of a
        new `PlanBank`); None restores the fleet-wide incumbent. The
        override must serve the same contexts, samples, branches, and bank
        keys -- a rollout changes CALIBRATION, not the data the fleet is
        benchmarked on."""
        if table is not None:
            base = self.table
            if (
                table.ctx_keys != base.ctx_keys
                or table.n_samples != base.n_samples
                or table.branches != base.branches
                or table.bank_keys != base.bank_keys
            ):
                raise ValueError(
                    "cell table override must match the incumbent's contexts/"
                    "samples/branches/bank keys"
                )
        self._cell_tables[cell] = table

    def _table_for(self, cell: int) -> GateTable:
        t = self._cell_tables[cell]
        return self.table if t is None else t

    def _payload_nbytes_for(self, branch: int, level: int) -> int:
        """Wire bytes for one offload from `branch` at codec `level`: the
        caller-supplied raw table untouched at level 0 (bit-exact legacy
        pricing), the codec's analytic size otherwise."""
        raw = self.payload_nbytes(branch)
        if level == 0:
            return raw
        return scaled_payload_nbytes(raw, level)

    def _energy_col(self, edge_time_s, on_device, branch, level) -> np.ndarray:
        """Per-request edge-side energy column: compute J for every gated
        request plus radio J for the offloaded payload's wire bytes (see
        `repro_torch.offload.latency.energy_per_request_j`)."""
        compute_j = edge_time_s * self.profile.edge_power_w
        radio_j = (
            float(self._payload_nbytes_for(branch, level)) * 8.0
            * self.profile.uplink_j_per_bit
        )
        return np.where(on_device, compute_j, compute_j + radio_j)

    def _cloud_scale_at(self, times: np.ndarray) -> np.ndarray:
        scale = np.ones(len(times))
        for a, b, f in self.config.cloud_slowdowns:
            scale[(times >= a) & (times < b)] *= f
        return scale

    # ----------------------------------------------------------------- run
    def run(self) -> FleetTelemetry:
        topo, cfg, table = self.topology, self.config, self.table
        tel = FleetTelemetry(
            topo.n_cells,
            context_keys=table.ctx_keys,
            bank_keys=table.bank_keys or None,
        )
        for c, cell in enumerate(topo.cells):
            tel.set_arrivals(c, cell.workload.arrival_s)

        # every run starts from the plan's deployment (a controller from a
        # previous run() must not leak its final decisions into this one),
        # and from the topology's declared activation mask / no overrides
        self._state = [self._initial_state for _ in topo.cells]
        self._active = topo.initial_active_mask()
        self._cell_tables = [None] * topo.n_cells
        self._backhaul_free = np.zeros(topo.n_cells)
        self.shed_counts = np.zeros(topo.n_cells, np.int64)
        orch = self.orchestrator
        self._live = _LiveCloud(topo.cloud_servers) if orch is not None else None
        dev_free = [np.zeros(cell.n_devices) for cell in topo.cells]
        uplink_free = np.zeros(topo.n_cells)
        ptr = np.zeros(topo.n_cells, np.int64)
        n_windows = int(math.ceil(max(topo.horizon_s, 0.0) / cfg.window_s)) + 1

        jobs = _CloudJobs()
        window_cols = []  # (cell, dict of columns), patched by the cloud solve
        if orch is not None:
            orch.attach(self, tel, audit=self._audit)
        for w in range(n_windows):
            t0, t1 = w * cfg.window_s, (w + 1) * cfg.window_s
            if orch is not None:
                if w > 0:
                    self._pop_live(t0, tel)
                orch.on_window(self, tel, w, t0)
            if (
                self.controller is not None
                and w > 0
                and w % self._ticks_per_update == 0
            ):
                self._apply_controller(t0, tel)

            for c, cell in enumerate(topo.cells):
                arr = cell.workload.arrival_s
                hi = int(np.searchsorted(arr, t1, side="left"))
                lo = int(ptr[c])
                ptr[c] = hi
                if hi == lo:
                    continue
                if self._active[c]:
                    branch, p_tar, clevel = self._state[c]
                    cols = self._edge_and_gate(
                        c, cell, lo, hi, branch, p_tar, clevel, dev_free[c]
                    )
                    serve_c = c
                else:
                    serve_c, cols = self._shed_window(
                        c, cell, lo, hi, dev_free, tel
                    )
                if self._tracing:
                    cols["serve_cell"] = serve_c
                est = cols["est_id"]
                tel.observe_contexts(
                    serve_c if serve_c >= 0 else c,
                    cols["edge_done"],
                    np.where(est >= 0, self._bank_to_table[np.maximum(est, 0)],
                             np.where(est == -2, cols["ctx_id"], -1)),
                )
                off = ~cols["on_device"]
                if self._metrics is not None:
                    self._metrics.inc("fleet_requests_total", hi - lo, cell=c)
                    n_off = int(off.sum())
                    if n_off:
                        self._metrics.inc("fleet_offloaded_total", n_off,
                                          cell=c)
                if off.any():
                    branch = int(cols["branch"][0])
                    order = np.argsort(cols["edge_done"][off], kind="stable")
                    pos = np.flatnonzero(off)[order]
                    t_ready = cols["edge_done"][pos]
                    nbytes = float(self._payload_nbytes_for(
                        branch, int(cols["clevel"][0])
                    ))
                    if self._metrics is not None:
                        # uplink AND backhaul payloads count: both cross a
                        # link toward the cloud, attributed to the origin
                        # cell (matching the trace records' `cell`)
                        self._metrics.inc("fleet_uplink_bytes_total",
                                          nbytes * len(pos), cell=c)
                    if serve_c >= 0:
                        net = topo.cells[serve_c].network
                        rates = net.rates_bps(t_ready)
                        done = fifo_done(t_ready, nbytes * 8.0 / rates,
                                         float(uplink_free[serve_c]))
                        # reprice at the actual transfer start (one fixed-
                        # point pass; exact for fixed links)
                        comm = nbytes * 8.0 / net.rates_bps(
                            done - nbytes * 8.0 / rates
                        )
                        done = fifo_done(t_ready, comm,
                                         float(uplink_free[serve_c]))
                        uplink_free[serve_c] = done[-1]
                        tel.observe_bandwidth(serve_c, t_ready,
                                              nbytes * 8.0 / comm)
                    else:  # whole-fleet outage: nominal-rate cloud backhaul
                        comm = np.full(
                            len(t_ready),
                            nbytes * 8.0 / self.profile.uplink_bps,
                        )
                        done = fifo_done(t_ready, comm,
                                         float(self._backhaul_free[c]))
                        self._backhaul_free[c] = done[-1]
                    service = L.cloud_time(self.profile, branch)
                    if cfg.cloud_slowdowns:
                        service = service * self._cloud_scale_at(done)
                    if self._tracing:
                        cols["uplink_start"][pos] = done - comm
                        cols["uplink_done"][pos] = done
                        cols["cloud_service"][pos] = service
                    jobs.add(done, service, len(window_cols), pos)
                    if self._live is not None:
                        self._live.add(done, service, c,
                                       cols["arrival"][pos], cols["deadline"])
                if self._live is not None:
                    self._observe_edge_live(c, cols, tel)
                window_cols.append((c, cols))

        self._cloud_solve(jobs, window_cols)
        self._flush(window_cols, tel)
        if self.obs is not None and self.obs.enabled:
            self._finish_obs(window_cols, tel)
        if orch is not None:
            orch.finish(self, tel, n_windows * cfg.window_s)
        return tel

    def _pop_live(self, now: float, tel) -> None:
        """Stream cloud completions whose transfer finished before `now`
        into the live QoS view (see `_LiveCloud`)."""
        live = self._live.pop(now)
        if live is None:
            return
        cells, done, lat, missed = live
        for c in np.unique(cells):
            m = cells == c
            tel.observe_live_latency(int(c), done[m], lat[m], missed[m])

    def _observe_edge_live(self, c, cols, tel) -> None:
        """Edge-resolved live observations: on-device requests complete at
        edge_done, so their latency/deadline/gate outcomes are final the
        moment the window is served. The calibration stream takes EVERY
        gated request (offloaded ones included -- the reliability
        diagram judges the gate's confidence, not who answered), with
        EDGE correctness, which at this point in the run is what
        cols['correct'] holds (the cloud solve patches it later)."""
        on = cols["on_device"]
        conf = cols.get("conf")
        if conf is not None:
            ec = cols.get("edge_correct", cols["correct"])
            g = np.isfinite(conf) & (ec >= 0)
            if g.any():
                tel.observe_live_calibration(
                    c, cols["edge_done"][g], conf[g], ec[g],
                    on[g].astype(np.int8),
                )
        if not on.any():
            return
        t = cols["edge_done"][on]
        lat = t - cols["arrival"][on]
        ded = cols["deadline"]
        missed = (
            np.full(len(lat), -1, np.int8)
            if ded is None
            else (lat > ded).astype(np.int8)
        )
        tel.observe_live_latency(c, t, lat, missed)
        ok = cols["correct"][on] >= 0
        if ok.any():
            tel.observe_live_gate(
                c, t[ok], cols["correct"][on][ok], cols["p_tar"][on][ok]
            )

    # ---------------------------------------------------------- edge tier
    def _edge_and_gate(self, c, cell, lo, hi, branch, p_tar, clevel, dev_free):
        wl = cell.workload
        return self._serve_cols(
            c, wl.arrival_s[lo:hi], wl.sample[lo:hi], wl.device[lo:hi],
            cell.n_devices, branch, p_tar, clevel, dev_free,
            ctx_cell=c, deadline_s=cell.deadline_s,
        )

    def _ctx_ids(self, c: int, times: np.ndarray) -> np.ndarray:
        """Table context ids in force at `times` under cell c's regime."""
        if self._sched_map[c] is None:
            return np.full(len(times), self._static_ctx[c], np.int64)
        return self._sched_map[c][
            self.topology.cells[c].schedule.context_ids_at(times)
        ]

    def _serve_cols(self, serve_c, arr, samples, devices, n_devices,
                    branch, p_tar, clevel, dev_free, ctx_cell, deadline_s):
        """Serve one window's columns on cell `serve_c`'s devices and gate
        table, under cell `ctx_cell`'s context regime (they differ only
        when a dead cell's load was shed here)."""
        s_edge = L.edge_time(self.profile, branch)
        n = len(arr)
        edge_done = np.empty(n)
        for d in range(n_devices):
            m = devices == d
            k = int(m.sum())
            if k == 0:
                continue
            done = fifo_done(arr[m], np.full(k, s_edge), float(dev_free[d]))
            edge_done[m] = done
            dev_free[d] = done[-1]

        ctx_ids = self._ctx_ids(ctx_cell, edge_done)
        table = self._table_for(serve_c)
        conf, pred, on = table.gate_window(ctx_ids, samples, branch, p_tar)
        est = table.est_ids(ctx_ids, samples)
        correct = table.correct(samples, pred)
        if self._cal is not None and correct is not None:
            # columnar sketch update at gate time: EDGE correctness
            # (before any cloud answer patches it), attributed to the
            # origin cell's context regime
            for cid in np.unique(ctx_ids):
                m = ctx_ids == cid
                self._cal.update(ctx_cell, table.ctx_keys[int(cid)], branch,
                                 conf[m], correct[m], on[m])
        cols = {
            "arrival": arr,
            "samples": samples,
            "edge_done": edge_done,
            "complete": edge_done.copy(),
            "on_device": on,
            "ctx_id": ctx_ids,
            "est_id": np.full(n, -2, np.int64) if est is None else est,
            "correct": (
                np.full(n, -1, np.int8)
                if correct is None
                else correct.astype(np.int8)
            ),
            "branch": np.full(n, branch, np.int64),
            "p_tar": np.full(n, p_tar),
            "clevel": np.full(n, int(clevel), np.int64),
            "energy_j": self._energy_col(
                L.edge_time(self.profile, branch), on, branch, int(clevel)
            ),
            "deadline": deadline_s,
        }
        if self._tracing:
            self._add_trace_cols(cols, conf)
        elif self._live is not None:
            # the live calibration stream needs the gate confidences even
            # without a trace sink (QoS windows ECE/coverage from them)
            cols["conf"] = np.asarray(conf, np.float64)
        return cols

    def _add_trace_cols(self, cols, conf) -> None:
        """Extra per-request columns kept ONLY while a trace sink is
        attached (never fed to telemetry): the gate confidence, the
        EDGE correctness (cols['correct'] before the cloud solve patches
        offloaded rows), plus the uplink/cloud span timestamps `run`
        stamps after the FIFO solves. conf=None marks a backhauled
        window where no gate ran."""
        n = len(cols["arrival"])
        cols["conf"] = (
            np.full(n, np.nan) if conf is None
            else np.asarray(conf, np.float64)
        )
        cols["edge_correct"] = cols["correct"].copy()
        cols["uplink_start"] = np.full(n, np.nan)
        cols["uplink_done"] = np.full(n, np.nan)
        cols["cloud_service"] = np.full(n, np.nan)

    def _shed_window(self, c, cell, lo, hi, dev_free, tel):
        """A dead cell's window: serve it on the nearest ACTIVE ring
        neighbor (that cell's devices, uplink, deployed state, and gate
        table; the ORIGIN cell's context regime and deadline), or, with no
        live neighbor anywhere, backhaul the whole window straight to the
        shared cloud at the nominal uplink rate. Latency columns stay
        attributed to the origin cell either way."""
        wl = cell.workload
        arr = wl.arrival_s[lo:hi]
        samples = wl.sample[lo:hi]
        n = hi - lo
        self.shed_counts[c] += n
        if self._metrics is not None:
            self._metrics.inc("fleet_shed_total", n, cell=c)
        for s in self.topology.shed_order(c):
            if self._active[s]:
                host = self.topology.cells[int(s)]
                branch, p_tar, clevel = self._state[int(s)]
                cols = self._serve_cols(
                    int(s), arr, samples,
                    wl.device[lo:hi] % host.n_devices, host.n_devices,
                    branch, p_tar, clevel, dev_free[int(s)],
                    ctx_cell=c, deadline_s=cell.deadline_s,
                )
                tel.observe_shed_arrivals(int(s), arr)
                if self._audit is not None:
                    self._audit.record(
                        float(arr[0]), "simulator", "shed_route", cell=c,
                        host_cell=int(s), backhaul=False, requests=int(n))
                return int(s), cols
        # whole-fleet outage: every request offloads over the backhaul
        if self._audit is not None:
            self._audit.record(
                float(arr[0]), "simulator", "shed_route", cell=c,
                host_cell=None, backhaul=True, requests=int(n))
        if self._cal is not None:
            # no gate ran: count the window so sketch totals still match
            # the fleet_requests_total counter
            self._cal.note_ungated(c, n)
        branch, p_tar, clevel = self._state[c]
        cols = {
            "arrival": arr,
            "samples": samples,
            "edge_done": arr.copy(),
            "complete": arr.copy(),
            "on_device": np.zeros(n, bool),
            "ctx_id": self._ctx_ids(c, arr),
            "est_id": np.full(n, -2, np.int64),
            "correct": np.full(n, -1, np.int8),
            "branch": np.full(n, branch, np.int64),
            "p_tar": np.full(n, p_tar),
            "clevel": np.full(n, int(clevel), np.int64),
            # no edge service ran on a backhauled window: radio J only
            "energy_j": self._energy_col(0.0, np.zeros(n, bool), branch,
                                         int(clevel)),
            "deadline": cell.deadline_s,
        }
        if self._tracing:
            self._add_trace_cols(cols, None)
        return -1, cols

    # ---------------------------------------------------------- cloud tier
    def _cloud_solve(self, jobs, window_cols):
        """One global K-server FIFO solve over every offloaded job, sorted
        by uplink completion: job i waits for job i-K (deterministic
        service), so each of the K residue classes is an independent
        single-server chain. Exact for uniform service times; with mixed
        branches in flight the completion order can locally deviate from
        the event heap's argmin-server rule (documented approximation)."""
        if not jobs.t:
            return
        t = np.concatenate(jobs.t)
        service = np.concatenate(jobs.service)
        win_of = np.concatenate(jobs.win)
        pos_of = np.concatenate(jobs.pos)
        order = np.argsort(t, kind="stable")
        t, service = t[order], service[order]
        win_of, pos_of = win_of[order], pos_of[order]
        k = self.topology.cloud_servers
        done = np.empty(len(t))
        for r in range(min(k, len(t))):
            idx = np.arange(r, len(t), k)
            done[idx] = fifo_done(t[idx], service[idx], 0.0)
        for w in np.unique(win_of):
            m = win_of == w
            cell_of_w, cols = window_cols[int(w)]
            table = self._table_for(cell_of_w)
            pos = pos_of[m]
            cols["complete"][pos] = done[m]
            # the deployed codec level is constant within a window, so the
            # per-level main-head table resolves once per window
            cpred = table.cloud_pred(cols["ctx_id"][pos],
                                     cols["samples"][pos],
                                     level=int(cols["clevel"][0]))
            correct = table.correct(cols["samples"][pos], cpred)
            if correct is not None:
                cols["correct"][pos] = correct.astype(np.int8)

    def _flush(self, window_cols, tel):
        for c, cols in window_cols:
            lat = cols["complete"] - cols["arrival"]
            if cols["deadline"] is None:
                missed = np.full(len(lat), -1, np.int8)
            else:
                missed = (lat > cols["deadline"]).astype(np.int8)
            tel.add_window(
                c,
                latency_s=lat,
                on_device=cols["on_device"],
                correct=cols["correct"],
                p_tar=cols["p_tar"],
                branch=cols["branch"],
                ctx_id=cols["ctx_id"],
                est_id=cols["est_id"],
                missed=missed,
                energy_j=cols["energy_j"],
            )

    # ------------------------------------------------------- observability
    def _finish_obs(self, window_cols, tel) -> None:
        """Post-run export: conservation gauges (expected vs completed vs
        offloaded, straight from the final patched columns), the fleet
        telemetry summary as gauges, then sampled trace emission."""
        if self._metrics is not None:
            offloaded = sum(
                int((~cols["on_device"]).sum()) for _, cols in window_cols
            )
            self._metrics.set_gauge(
                "fleet_requests_expected", self.topology.n_requests
            )
            self._metrics.set_gauge("fleet_requests_completed", tel.requests())
            self._metrics.set_gauge("fleet_offloaded_telemetry", offloaded)
            if self._tracing:
                self._metrics.set_gauge(
                    "trace_sample_every",
                    max(1, int(self.obs.trace_sample_every)),
                    source="fleet",
                )
            fleet_metrics(tel, self._metrics)
            if self._cal is not None:
                export_calibration(self._cal, self._metrics)
        if self._tracing:
            self._emit_traces(window_cols)

    def _emit_traces(self, window_cols) -> None:
        """Emit sampled per-request trace records from the final patched
        columns. Sampling is a deterministic global stride over the
        flattened window order, so a run emits the same records every
        time; req_id is the request's global index in that order. Edge
        service start is recovered exactly (deterministic service time);
        uplink/cloud span edges were stamped during the FIFO solves."""
        sink = self.obs.trace
        every = max(1, int(self.obs.trace_sample_every))
        ctx_keys = self.table.ctx_keys
        bank_keys = self.table.bank_keys
        counter = 0
        emitted = 0
        for c, cols in window_cols:
            n = len(cols["arrival"])
            backhaul = int(cols["serve_cell"]) < 0
            branch = int(cols["branch"][0])
            s_edge = 0.0 if backhaul else L.edge_time(self.profile, branch)
            clevel = int(cols["clevel"][0])
            pn_off = float(self._payload_nbytes_for(branch, clevel))
            for i in range((-counter) % every, n, every):
                arrival = float(cols["arrival"][i])
                edge_done = float(cols["edge_done"][i])
                complete = float(cols["complete"][i])
                on = bool(cols["on_device"][i])
                edge_start = edge_done - s_edge
                if on:
                    spans = build_spans(arrival, edge_start, edge_done)
                else:
                    spans = build_spans(
                        arrival, edge_start, edge_done,
                        uplink_start_s=float(cols["uplink_start"][i]),
                        uplink_done_s=float(cols["uplink_done"][i]),
                        cloud_start_s=(
                            complete - float(cols["cloud_service"][i])
                        ),
                        complete_s=complete,
                    )
                if backhaul:
                    gate = None  # no gate ran: the window went straight up
                else:
                    ctx_id = int(cols["ctx_id"][i])
                    est_id = int(cols["est_id"][i])
                    ec = int(cols["edge_correct"][i])
                    gate = {
                        "branch": branch,
                        "p_tar": float(cols["p_tar"][i]),
                        "confidence": float(cols["conf"][i]),
                        "criterion": "confidence",
                        "context": ctx_keys[ctx_id] if ctx_id >= 0 else None,
                        "est_context": (
                            bank_keys[est_id]
                            if bank_keys and 0 <= est_id < len(bank_keys)
                            else None
                        ),
                        # EDGE correctness at gate time (-1 = unlabeled),
                        # what the calibration sketch accumulated
                        "correct": None if ec < 0 else ec,
                    }
                    if not on:
                        gate["compression_level"] = clevel
                sink.emit(request_record(
                    "fleet", counter + i, arrival, complete, on, spans,
                    gate=gate, cell=c,
                    payload_nbytes=None if on else pn_off,
                ))
                emitted += 1
            counter += n
        if self._metrics is not None and emitted:
            self._metrics.inc("trace_records_total", emitted, source="fleet")

    # ---------------------------------------------------------- controller
    def _apply_controller(self, t: float, tel: FleetTelemetry) -> None:
        if self.orchestrator is not None:
            mon = getattr(self.orchestrator, "monitor", None)
            if mon is not None:
                # satellite wiring (ROADMAP): the QoS monitor's trip verdict
                # IS the controller's distress signal -- a tripped cell takes
                # the rescue concession until the monitor clears it
                decisions = self.controller.update(
                    t, tel, active=self._active,
                    distressed=mon.tripped_mask(),
                )
            else:
                decisions = self.controller.update(t, tel, active=self._active)
        else:
            decisions = self.controller.update(t, tel)
        if len(decisions) != self.topology.n_cells:
            raise ValueError(
                f"controller returned {len(decisions)} decisions for "
                f"{self.topology.n_cells} cells"
            )
        for c, dec in enumerate(decisions):
            # legacy controllers return (branch, p_tar) 2-tuples; the
            # compression-aware fleet controller appends the codec level
            if len(dec) == 2:
                branch, p_tar = dec
                level = 0
            else:
                branch, p_tar, level = dec
            state = (int(branch), float(p_tar), int(level))
            if state != self._state[c]:
                tel.record_controller(t, c, branch, float(p_tar),
                                      level=int(level))
            self._state[c] = state
