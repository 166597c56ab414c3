"""Online offload controller (Edgent-style, 1806.07840).

Port of `repro.serving.controller`. The controller core's validation
blocks are gate blocks of the selected `GateBackend` (`backend`, the
port's ``"torch"`` by default: one K1 launch per (context, branch) on
the card at construction); every tick is host numpy over the cached
statistics.

Every `interval_s` of simulated time the controller looks at a trailing
window of telemetry -- the mean uplink rate observed by actual transfers
and the mean queue depth -- and re-scores the deployed `OffloadPlan`
through the shared `repro_torch.core.control.ControllerCore`: the plan's fitted
per-exit calibrators are applied to held-out validation logits (no
re-fitting), each candidate (branch, effective p_tar) is priced with the
Neurosurgeon expected-latency objective at the MEASURED bandwidth, and
the cheapest candidate that still meets the accuracy floor (and, when
capped, the estimated reliability-gap contract) wins. Queue pressure
scales the effective edge service time (each queued request adds one
service quantum of wait), so a backed-up fleet biases toward
configurations that offload less.

Built with per-context validation logits (``{context: {branch: (N, C)}}``
+ per-context final logits), the controller is CONTEXT-AWARE -- the
fleet's mix-weighted re-scoring, ported back to the event runtime: each
tick it asks its own telemetry for the trailing-window traffic mix
(`Telemetry.context_mix_estimate`, fed by gate-time context verdicts) and
weights the validation samples by each context's observed share, so the
candidate table prices the drifting inputs actually being served instead
of the clean distribution.

The controller owns no queues and no clock: `ServingRuntime` calls
`update(t, telemetry)` and applies the returned plan's (exit_index, p_tar).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.control import ControlConfig, ControllerCore, hold_incumbent
from repro_torch.core.policy import OffloadPlan, rescore_plan  # noqa: F401  (re-export)
from repro_torch.offload import latency as L


@dataclass
class ControllerConfig(ControlConfig):
    """The shared control knobs (`repro_torch.core.control.ControlConfig`) plus
    the event runtime's queue-awareness."""

    queue_aware: bool = True  # inflate edge time by observed queue depth


class OnlineController:
    """Re-selects (deployed branch, effective p_tar) from telemetry.

    exit_logits: {physical_branch: (N, C) held-out validation logits}
    (the `LogitsCore` convention), or {context: {branch: (N, C)}} with
    per-context `final_logits` for the context-aware mix-weighted
    re-score. `labels`/`final_logits` enable the accuracy floor and the
    reliability-gap cap; without them candidates are ranked by latency
    alone.

    Accepts a `repro_torch.core.bank.PlanBank` in place of the plan: the bank's
    default plan is re-scored, so the controller moves the fleet-wide
    (branch, p_tar) while the bank keeps picking per-context expert
    calibrators inside the contextual core -- bandwidth-driven re-scoring
    and distortion-driven expert selection compose without touching each
    other's state.

    `backend` selects the gate execution path of the controller core
    (`repro_torch.core.gatepath`): None is ``"torch"``, which runs on the
    card and raises without one; ``"numpy"`` or
    ``TorchGateBackend(device="cpu")`` stay on the host.
    """

    def __init__(
        self,
        plan: OffloadPlan,
        profile: L.LatencyProfile,
        exit_logits: Dict,
        final_logits=None,
        labels: Optional[np.ndarray] = None,
        config: Optional[ControllerConfig] = None,
        payload_nbytes=None,
        backend=None,
    ):
        self.config = config or ControllerConfig()
        self.core = ControllerCore(
            plan, profile, exit_logits,
            final_logits=final_logits, labels=labels,
            payload_nbytes=payload_nbytes,
            backend=backend,
            compression_levels=self.config.compression_levels,
        )
        if self.config.max_reliability_gap is not None and not self.core.has_labels:
            raise ValueError(
                "max_reliability_gap needs labels to estimate candidate "
                "on-device accuracy"
            )
        self.plan = self.core.plan
        self.profile = profile
        self.history: List[Tuple[float, float, int, float]] = []  # (t, bw, branch, p_tar)
        #: optional repro_torch.obs.AuditLog; ServingRuntime injects it when an
        #: Observability bundle is attached. Purely write-only evidence.
        self.audit = None

    @property
    def branches(self) -> List[int]:
        return self.core.branches

    @property
    def interval_s(self) -> float:
        return self.config.interval_s

    def update(self, t: float, telemetry) -> OffloadPlan:
        cfg = self.config
        bw = telemetry.bandwidth_estimate(cfg.window_s, now=t)
        if bw is None:
            bw = self.profile.uplink_bps  # nothing measured yet: trust nominal
        edge_times = None
        if cfg.queue_aware:
            depth = telemetry.queue_estimate(cfg.window_s, now=t)
            if depth is not None and depth > 0:
                edge_times = [
                    e * (1.0 + depth) for e in self.core.edge_times_s
                ]
        rate_hz = None
        if cfg.utilization_aware:
            rate_hz = telemetry.arrival_rate_estimate(cfg.window_s, now=t)
        weight = None
        if self.core.context_aware:
            mix = telemetry.context_mix_estimate(cfg.window_s, now=t)
            weight = self.core.sample_weight_for_mix(mix)

        # candidate table under measured conditions (calibrators re-used)
        candidate, table = self.core.rescore(
            self.plan,
            uplink_bps=bw,
            edge_times_s=edge_times,
            arrival_rate_hz=rate_hz,
            p_tar_grid=cfg.p_tar_grid,
            branches=cfg.branches,
            min_accuracy=cfg.min_accuracy,
            max_reliability_gap=cfg.max_reliability_gap,
            sample_weight=weight,
        )
        # hysteresis: keep the incumbent unless the ADOPTED candidate (the
        # feasible winner, not the global latency minimum) is clearly
        # better -- but never retain an incumbent that itself violates the
        # accuracy floor or the reliability-gap cap
        if hold_incumbent(
            table, self.plan, candidate, cfg.hysteresis,
            min_accuracy=cfg.min_accuracy,
            max_reliability_gap=cfg.max_reliability_gap,
        ):
            candidate = self.plan  # not worth churning the fleet
        held = candidate is self.plan
        prev = self.plan
        self.plan = candidate
        self.history.append((t, bw, candidate.exit_index + 1, candidate.p_tar))
        if self.audit is not None:
            self.audit.record(
                t, "online_controller", "controller_rescore",
                bandwidth_bps=float(bw),
                arrival_rate_hz=None if rate_hz is None else float(rate_hz),
                held=bool(held),
                changed=bool(candidate.exit_index != prev.exit_index
                             or candidate.p_tar != prev.p_tar
                             or candidate.compression_level
                             != prev.compression_level),
                chosen={"branch": candidate.exit_index + 1,
                        "p_tar": float(candidate.p_tar),
                        "compression_level": int(candidate.compression_level)},
            )
        return candidate
