"""Discrete-event edge-cloud serving runtime.

Models the paper's two-tier system under load instead of in the mean:

    N edge devices (FIFO, one request in service at a time)
        -> calibrated gate (the deployed OffloadPlan, current branch/p_tar)
        -> microbatcher (coalesces refused samples into cloud batches)
        -> ONE shared uplink (NetworkModel prices each transfer at the
           instantaneous rate when it starts)
        -> cloud tier (`cloud_servers` parallel servers, per-sample serial
           service within a batch)

Event list is a heap of (time, seq, fn); all randomness lives in the
workload and network models, so a run is bit-reproducible. Service times
come from a `LatencyProfile` via `offload.latency.edge_time`/`cloud_time`,
which makes the empty-queue single-device fixed-network special case agree
with the paper's closed-form per-sample numbers to float round-off.

Compute cores decouple the queueing model from the math that decides the
gate: `LogitsCore` serves precomputed per-branch logits (fast, exact,
drives tests/benchmarks); `EngineCore` drives a real `OffloadEngine` pair
of partitions per request, reusing its timing hooks. A core
with ``contextual = True`` (`repro_torch.serving.drift.ContextualLogitsCore`)
additionally models drifting input conditions: its gate takes the event
time and reports the (true, estimated) distortion context, and the runtime
threads both into telemetry. Passing a `PlanBank` instead of a single
`OffloadPlan` deploys the bank's default plan for (branch, p_tar) while
the contextual core picks each sample's expert calibrator.

Port of `repro.serving.runtime`. The event loop is host Python, as in
the reference. The cores follow the port's device rule: `LogitsCore` and
`EngineCore` run their tensors on `device` (``cuda`` unless the caller
names the CPU; without a GPU they raise). On the card, `LogitsCore`'s
gate statistics are one K1 launch per branch at construction and a
non-zero codec level's cloud table one K3 and one K4 launch (the final
logits round-trip the codec once per level); `EngineCore` makes one K1
launch per request and, for an offloaded request at a non-zero level, one
K3 and one K4 launch on its payload.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch._device import as_tensor, resolve_device, to_numpy
from repro_torch.core.exits import gate_statistics
from repro_torch.core.policy import OffloadPlan
from repro_torch.kernels.compress import roundtrip, scaled_payload_nbytes
from repro_torch.obs.calibration import GLOBAL_CONTEXT as _GLOBAL_CONTEXT
from repro_torch.offload import latency as L
from repro_torch.serving.network import NetworkModel, network_for
from repro_torch.serving.telemetry import RequestRecord, Telemetry
from repro_torch.serving.workload import Request


# ------------------------------------------------------------ compute cores
class LogitsCore:
    """Gate/cloud decisions from precomputed logits.

    exit_logits: {physical_branch: (N, C) logits} -- e.g. {1: z1, 2: z2};
    physical branch k gates with plan.calibrators[k-1] (engine convention).
    Confidence/prediction/entropy per branch are precomputed once (on
    `device`: K1 on the card) and kept as host arrays; only the mask
    depends on the runtime's current p_tar, so branch/target switches
    by the controller are free. Both of the plan's criteria are honored:
    'confidence' gates on conf >= p_tar (the runtime's moving target),
    'entropy' on the plan's fixed entropy_threshold.
    """

    def __init__(
        self,
        exit_logits: Dict[int, np.ndarray],
        final_logits: np.ndarray,
        plan: OffloadPlan,
        labels: Optional[np.ndarray] = None,
        device=None,
    ):
        if plan.criterion == "entropy" and plan.entropy_threshold is None:
            raise ValueError("entropy criterion needs plan.entropy_threshold")
        device = resolve_device(device)
        self.criterion = plan.criterion
        self.entropy_threshold = plan.entropy_threshold
        self.branches = sorted(exit_logits)
        self.conf: Dict[int, np.ndarray] = {}
        self.pred: Dict[int, np.ndarray] = {}
        self.ent: Dict[int, np.ndarray] = {}
        for b in self.branches:
            z = as_tensor(exit_logits[b], device)
            c, p, e = gate_statistics(plan.calibrated_logits(z, b - 1))
            self.conf[b] = to_numpy(c).astype(np.float64)
            self.pred[b] = to_numpy(p)
            self.ent[b] = to_numpy(e).astype(np.float64)
        self._final_logits = as_tensor(final_logits, device)
        self.final_pred = np.argmax(to_numpy(self._final_logits), axis=-1)
        self._final_pred_by_level: Dict[int, np.ndarray] = {}
        self.labels = None if labels is None else to_numpy(labels)
        self.n_samples = int(self.final_pred.shape[0])

    def gate(self, sample: int, branch: int, p_tar: float):
        """-> (on_device, prediction, confidence) for one sample."""
        conf = self.conf[branch][sample]
        if self.criterion == "entropy":
            on_device = bool(self.ent[branch][sample] <= self.entropy_threshold)
        else:
            on_device = bool(conf >= p_tar)
        return on_device, int(self.pred[branch][sample]), float(conf)

    def cloud_predict(self, sample: int, branch: int, level: int = 0) -> int:
        # every cloud path computes the same main head, whichever branch
        # the split happened at; a non-zero codec level round-trips the
        # stored final logits through the codec (K3/K4 on the card; the
        # codec is bit-exact with the reference's oracle), lazily, once
        # per level -- the fit-time accuracy-delta model, made live
        level = int(level)
        if level == 0:
            return int(self.final_pred[sample])
        if level not in self._final_pred_by_level:
            self._final_pred_by_level[level] = np.argmax(
                to_numpy(roundtrip(self._final_logits, level)), axis=-1
            )
        return int(self._final_pred_by_level[level][sample])

    def correct(self, sample: int, prediction: int) -> Optional[bool]:
        if self.labels is None:
            return None
        return bool(prediction == self.labels[sample])


class EngineCore:
    """Gate/cloud decisions computed live by OffloadEngine partitions.

    engines: {physical_branch: OffloadEngine} (one per deployable branch;
    a single-entry dict serves the paper's fixed-branch case). `data` is
    the batch pytree of the full dataset; requests index into its leading
    axis. Every leaf is moved to `device` (``cuda`` unless the caller
    names the CPU) once, so a request's batch is a slice of a tensor
    already on the engines' device. Uses the engines' edge_step/cloud_step
    so their timing hooks and EngineStats keep working under the
    simulated clock. Each gate reads the sample's confidence back to the
    host (one sync per request on the card), as the reference does.
    """

    def __init__(
        self,
        engines: Dict[int, "OffloadEngine"],  # noqa: F821
        data: Dict[str, np.ndarray],
        labels: Optional[np.ndarray] = None,
        device=None,
    ):
        device = resolve_device(device)
        self.engines = engines
        self.branches = sorted(engines)
        self.data = pytree.tree_map(lambda x: torch.as_tensor(x, device=device), data)
        self.labels = None if labels is None else to_numpy(labels)
        leaves = pytree.tree_leaves(self.data)
        self.n_samples = int(leaves[0].shape[0])
        # (sample, branch) -> edge activation. Keyed by branch so a repeat
        # of the same sample after a controller branch switch cannot hand
        # an in-flight cloud batch the other partition's payload; kept (not
        # popped) because the payload is deterministic per key, bounding
        # the cache at n_samples * n_branches entries.
        self._payload: Dict[tuple, object] = {}

    def gate(self, sample: int, branch: int, p_tar: float):
        eng = self.engines[branch]
        batch = pytree.tree_map(lambda x: x[sample : sample + 1], self.data)
        edge_out = eng.edge_step(batch)
        gate = eng.plan.gate(edge_out["exit_logits"], branch=eng.branch,
                             use_kernel=eng.use_kernel)
        conf = float(to_numpy(gate.confidence)[0])
        pred = int(to_numpy(gate.prediction)[0])
        on_device = bool(conf >= p_tar) if eng.plan.criterion == "confidence" \
            else bool(to_numpy(gate.exit_mask)[0])
        if not on_device:
            self._payload[(sample, branch)] = edge_out["payload"]
        return on_device, pred, conf

    def cloud_predict(self, sample: int, branch: int, level: int = 0) -> int:
        payload = self._payload[(sample, branch)]
        if int(level) != 0:
            # the REAL codec on the real activation: what the cloud
            # partition actually receives after a compressed offload
            payload = pytree.tree_map(
                lambda x: roundtrip(x, int(level)), payload
            )
        out = self.engines[branch].cloud_step(payload)
        return int(np.argmax(to_numpy(out["logits"]), axis=-1)[0])

    def correct(self, sample: int, prediction: int) -> Optional[bool]:
        if self.labels is None:
            return None
        return bool(prediction == self.labels[sample])


# ------------------------------------------------------------------ runtime
@dataclass
class RuntimeConfig:
    n_devices: int = 1
    max_batch: int = 1  # microbatcher: flush at this many refused samples
    batch_window_s: float = 0.0  # ... or when the oldest has waited this long
    cloud_servers: int = 1


@dataclass
class _Pending:
    """A refused request waiting in the microbatcher / cloud pipeline."""

    request: Request
    branch: int
    p_tar: float
    confidence: float
    edge_start_s: float
    edge_done_s: float
    payload_nbytes: int  # WIRE bytes at the deployed codec level
    compression_level: int = 0  # codec level the payload shipped at
    context: Optional[str] = None  # true distortion context at gate time
    est_context: Optional[str] = None  # what the edge-side estimator said
    # EDGE prediction's correctness captured at gate time (before the
    # cloud answer overrides it); stamped only while obs is attached
    edge_correct: Optional[bool] = None
    # span timestamps, stamped only while a trace sink is attached
    uplink_start_s: float = 0.0
    uplink_done_s: float = 0.0
    cloud_start_s: float = 0.0


class ServingRuntime:
    """Run a workload through the two-tier system; returns `Telemetry`.

    The deployed configuration starts at the plan's (exit_index+1, p_tar)
    and is updated in place whenever the optional `controller` re-scores
    the plan at its tick interval. A branch switch flushes the pending
    microbatch so every cloud batch is gated under one configuration.
    """

    def __init__(
        self,
        core,
        profile: L.LatencyProfile,
        plan: OffloadPlan,
        requests: Sequence[Request],
        network: Optional[NetworkModel] = None,
        config: RuntimeConfig = None,
        controller=None,
        telemetry: Optional[Telemetry] = None,
        payload_nbytes: Optional[Callable[[int], int]] = None,
        obs=None,
    ):
        from repro_torch.core.bank import PlanBank

        self.core = core
        self.profile = profile
        if isinstance(plan, PlanBank):
            # the bank's default plan seeds (branch, p_tar); per-sample
            # expert calibration happens inside the contextual core
            plan = plan.default_plan
        self.plan = plan
        self._contextual = bool(getattr(core, "contextual", False))
        self.requests = sorted(requests, key=lambda r: r.arrival_s)
        self.network = network or network_for(profile)
        self.config = config or RuntimeConfig()
        self.controller = controller
        self.telemetry = telemetry or Telemetry()
        # observability (repro_torch.obs.Observability); zero-perturbation when
        # absent -- the obs=None path runs operation-for-operation the
        # same code, pinned bit-exactly by tests/test_torch_obs.py
        self.obs = obs
        self._trace = None if obs is None else obs.trace
        self._metrics = None if obs is None else obs.metrics
        self._cal = None if obs is None else getattr(obs, "calibration", None)
        if obs is not None and obs.audit is not None \
                and controller is not None and hasattr(controller, "audit"):
            controller.audit = obs.audit
        if self._metrics is not None:
            self._metrics.set_gauge("trace_sample_every", 1, source="serving")
        if payload_nbytes is None:
            from repro_torch.models.convnet import payload_bytes  # the paper's model

            payload_nbytes = payload_bytes
        self.payload_nbytes = payload_nbytes

        self.branch = plan.exit_index + 1
        self.p_tar = float(plan.p_tar)
        self.level = int(getattr(plan, "compression_level", 0))
        if self.branch not in core.branches:
            raise ValueError(
                f"plan deploys branch {self.branch} but the core only "
                f"serves branches {core.branches}"
            )
        if controller is not None and not set(controller.branches) <= set(
            core.branches
        ):
            raise ValueError(
                f"controller may deploy branches {controller.branches} but "
                f"the core only serves {core.branches}"
            )

        # event machinery
        self._heap: List = []
        self._seq = 0
        self._now = 0.0
        # device state
        n = self.config.n_devices
        self._dev_queue: List[List[Request]] = [[] for _ in range(n)]
        self._dev_busy = [False] * n
        # microbatcher / uplink / cloud state
        self._batch: List[_Pending] = []
        self._batch_epoch = 0  # invalidates stale window-flush timers
        self._uplink_free_s = 0.0
        self._cloud_free_s = [0.0] * self.config.cloud_servers

    # -------------------------------------------------------------- events
    def _push(self, t: float, fn: Callable, *args) -> None:
        heapq.heappush(self._heap, (t, self._seq, fn, args))
        self._seq += 1

    def run(self) -> Telemetry:
        for req in self.requests:
            self._push(req.arrival_s, self._on_arrival, req)
        if self.controller is not None and self.requests:
            # first tick only; each tick re-schedules the next while the
            # simulation still has events, so adaptation continues through
            # the drain phase after the last arrival
            self._push(self.controller.interval_s, self._on_controller_tick)
        while self._heap:
            t, _, fn, args = heapq.heappop(self._heap)
            self._now = t
            fn(t, *args)
        self._flush_batch(self._now)  # drain stragglers (window=0, partial batch)
        while self._heap:
            t, _, fn, args = heapq.heappop(self._heap)
            self._now = t
            fn(t, *args)
        if self._metrics is not None:
            from repro_torch.obs import serving_metrics

            serving_metrics(self.telemetry, self._metrics)
            if self._cal is not None:
                from repro_torch.obs import export_calibration

                export_calibration(self._cal, self._metrics)
        return self.telemetry

    # ---------------------------------------------------------- edge tier
    def _on_arrival(self, t: float, req: Request) -> None:
        d = req.device % self.config.n_devices
        self.telemetry.observe_arrival(t)
        self._dev_queue[d].append(req)
        # mean PER-DEVICE edge backlog (batcher excluded): this is what the
        # controller multiplies edge service time by, so a 4-device fleet
        # must not look 4x more backed up than each device actually is
        self.telemetry.observe_queue(
            t, sum(len(q) for q in self._dev_queue) / self.config.n_devices
        )
        if not self._dev_busy[d]:
            self._start_edge(t, d)

    def _start_edge(self, t: float, d: int) -> None:
        req = self._dev_queue[d].pop(0)
        self._dev_busy[d] = True
        # capture the WHOLE configuration now: a controller tick during the
        # service must not pair this branch's logits with a p_tar tuned for
        # another branch
        branch, p_tar, level = self.branch, self.p_tar, self.level
        service = L.edge_time(self.profile, branch)
        self._push(
            t + service, self._on_edge_done, req, d, t, branch, p_tar, level
        )

    def _payload_nbytes_for(self, branch: int, level: int) -> int:
        """Wire bytes for one offload: the raw activation size at level 0
        (the caller-supplied table untouched -- bit-exact legacy pricing),
        the codec's analytic size otherwise."""
        raw = self.payload_nbytes(branch)
        if level == 0:
            return raw
        return scaled_payload_nbytes(raw, level)

    def _on_edge_done(
        self, t: float, req: Request, d: int, start_s: float, branch: int,
        p_tar: float, level: int = 0,
    ) -> None:
        if self._contextual:
            on_device, pred, conf, ctx, est = self.core.gate(
                req.sample, branch, p_tar, t
            )
            if ctx is not None:
                # the edge-side verdict when an estimator ran, else the
                # true context -- the stream a context-aware controller
                # windows into its traffic-mix estimate
                self.telemetry.observe_context(t, est if est is not None else ctx)
        else:
            on_device, pred, conf = self.core.gate(req.sample, branch, p_tar)
            ctx = est = None
        if on_device:
            ok = self.core.correct(req.sample, pred)
            self.telemetry.add(
                RequestRecord(
                    req_id=req.req_id,
                    arrival_s=req.arrival_s,
                    device=d,
                    branch=branch,
                    p_tar=p_tar,
                    on_device=True,
                    edge_start_s=start_s,
                    edge_done_s=t,
                    complete_s=t,
                    correct=ok,
                    deadline_s=req.deadline_s,
                    context=ctx,
                    est_context=est,
                    energy_j=L.energy_per_request_j(self.profile, t - start_s),
                )
            )
            if self.obs is not None and self.obs.enabled:
                self._observe_complete(req, d, branch, p_tar, conf, ctx, est,
                                       start_s, t, on_device=True,
                                       edge_correct=ok)
        else:
            p = _Pending(req, branch, p_tar, conf, start_s, t,
                         self._payload_nbytes_for(branch, level),
                         compression_level=level, context=ctx,
                         est_context=est)
            if self.obs is not None and self.obs.enabled:
                # the edge branch's own verdict, evaluated before the
                # cloud main head replaces the answer: the calibration
                # stream audits the GATE, not the cloud
                p.edge_correct = self.core.correct(req.sample, pred)
            self._batch.append(p)
            if len(self._batch) >= self.config.max_batch:
                self._flush_batch(t)
            elif len(self._batch) == 1 and self.config.batch_window_s > 0:
                self._push(
                    t + self.config.batch_window_s,
                    self._on_batch_window,
                    self._batch_epoch,
                )
        self._dev_busy[d] = False
        if self._dev_queue[d]:
            self._start_edge(t, d)

    # ------------------------------------------------- microbatch + uplink
    def _on_batch_window(self, t: float, epoch: int) -> None:
        if epoch == self._batch_epoch and self._batch:
            self._flush_batch(t)

    def _flush_batch(self, t: float) -> None:
        if not self._batch:
            return
        batch, self._batch = self._batch, []
        self._batch_epoch += 1
        nbytes = sum(p.payload_nbytes for p in batch)
        if self._metrics is not None:
            self._metrics.inc("serving_uplink_bytes_total", nbytes)
        start = max(t, self._uplink_free_s)
        # observation timestamped NOW (flush time), not at the transfer's
        # start: under backlog `start` lies in the future and a sample
        # there would fall outside the controller's trailing window
        # exactly when it matters most
        self.telemetry.observe_bandwidth(t, self.network.rate_bps(start))
        done = start + self.network.comm_time(nbytes, start)
        self._uplink_free_s = done
        if self._trace is not None:
            for p in batch:
                p.uplink_start_s, p.uplink_done_s = start, done
        self._push(done, self._on_uplink_done, batch)

    # ----------------------------------------------------------- cloud tier
    def _on_uplink_done(self, t: float, batch: List[_Pending]) -> None:
        i = int(np.argmin(self._cloud_free_s))
        start = max(t, self._cloud_free_s[i])
        service = sum(L.cloud_time(self.profile, p.branch) for p in batch)
        done = start + service
        self._cloud_free_s[i] = done
        if self._trace is not None:
            for p in batch:
                p.cloud_start_s = start
        self._push(done, self._on_cloud_done, batch)

    def _on_cloud_done(self, t: float, batch: List[_Pending]) -> None:
        for p in batch:
            if self._contextual:
                # the cloud main head also sees the distorted input, so its
                # prediction is conditioned on the gate-time true context
                pred = self.core.cloud_predict(p.request.sample, p.branch,
                                               p.context,
                                               level=p.compression_level)
            else:
                pred = self.core.cloud_predict(p.request.sample, p.branch,
                                               level=p.compression_level)
            self.telemetry.add(
                RequestRecord(
                    req_id=p.request.req_id,
                    arrival_s=p.request.arrival_s,
                    device=p.request.device % self.config.n_devices,
                    branch=p.branch,
                    p_tar=p.p_tar,
                    on_device=False,
                    edge_start_s=p.edge_start_s,
                    edge_done_s=p.edge_done_s,
                    complete_s=t,
                    correct=self.core.correct(p.request.sample, pred),
                    deadline_s=p.request.deadline_s,
                    context=p.context,
                    est_context=p.est_context,
                    energy_j=L.energy_per_request_j(
                        self.profile, p.edge_done_s - p.edge_start_s,
                        p.payload_nbytes,
                    ),
                )
            )
            if self.obs is not None and self.obs.enabled:
                self._observe_complete(
                    p.request, p.request.device % self.config.n_devices,
                    p.branch, p.p_tar, p.confidence, p.context,
                    p.est_context, p.edge_start_s, p.edge_done_s,
                    on_device=False, uplink_start_s=p.uplink_start_s,
                    uplink_done_s=p.uplink_done_s,
                    cloud_start_s=p.cloud_start_s, complete_s=t,
                    edge_correct=p.edge_correct,
                    payload_nbytes=p.payload_nbytes,
                    level=p.compression_level,
                )

    # -------------------------------------------------------- observability
    def _observe_complete(
        self, req: Request, d: int, branch: int, p_tar: float, conf: float,
        ctx, est, edge_start_s: float, edge_done_s: float, on_device: bool,
        uplink_start_s: Optional[float] = None,
        uplink_done_s: Optional[float] = None,
        cloud_start_s: Optional[float] = None,
        complete_s: Optional[float] = None,
        edge_correct: Optional[bool] = None,
        payload_nbytes: Optional[int] = None,
        level: int = 0,
    ) -> None:
        """Trace + metrics for one completed request (sinks attached)."""
        from repro_torch.obs import build_spans, request_record

        complete = edge_done_s if complete_s is None else complete_s
        if self._metrics is not None:
            self._metrics.inc("serving_requests_total",
                              path="edge" if on_device else "cloud")
            self._metrics.observe("serving_latency_ms",
                                  (complete - req.arrival_s) * 1e3)
        if self._cal is not None and edge_correct is not None:
            self._cal.update_one(
                0, ctx if ctx is not None else _GLOBAL_CONTEXT, branch,
                conf, edge_correct, on_device)
        if self._trace is None:
            return
        gate = {
            "branch": int(branch),
            "p_tar": float(p_tar),
            "confidence": float(conf),
            "criterion": getattr(self.core, "criterion",
                                 getattr(self.plan, "criterion", None)),
            "context": ctx,
            "est_context": est,
            "correct": None if edge_correct is None else int(edge_correct),
        }
        if not on_device:
            gate["compression_level"] = int(level)
        spans = build_spans(req.arrival_s, edge_start_s, edge_done_s,
                            uplink_start_s, uplink_done_s, cloud_start_s,
                            complete_s)
        self._trace.emit(request_record(
            "serving", req.req_id, req.arrival_s, complete, on_device,
            spans, gate=gate, device=d, payload_nbytes=payload_nbytes))
        if self._metrics is not None:
            self._metrics.inc("trace_records_total", source="serving")

    # ----------------------------------------------------------- controller
    def _on_controller_tick(self, t: float) -> None:
        new_plan = self.controller.update(t, self.telemetry)
        new_branch = new_plan.exit_index + 1  # validated against the core at init
        new_p_tar = float(new_plan.p_tar)
        new_level = int(getattr(new_plan, "compression_level", 0))
        if new_branch != self.branch:
            self._flush_batch(t)  # pending batch was gated under the old config
        if (new_branch != self.branch or new_p_tar != self.p_tar
                or new_level != self.level):
            self.telemetry.record_controller(t, new_branch, new_p_tar,
                                             level=new_level)
        self.branch, self.p_tar, self.level = new_branch, new_p_tar, new_level
        if self._heap:  # more simulation ahead (requests in flight/queued)
            self._push(t + self.controller.interval_s, self._on_controller_tick)
