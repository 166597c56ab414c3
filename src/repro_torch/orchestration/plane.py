"""The orchestrator: one object the fleet simulator calls per window.

Wiring order inside a window boundary at time t0 (the simulator calls
`on_window` BEFORE the controller tick, and pops the live cloud view
first, so the monitor judges completions strictly before t0):

    1. churn   -- apply every scheduled join/leave with t <= t0;
    2. monitor -- one QoS evaluation pass over the trailing window;
    3. rollout -- advance the canary state machine on the fresh verdicts.

Every action lands in `FleetTelemetry.orchestration_events`, so a run's
operational history replays from its telemetry alone. The orchestrator
re-arms itself on `attach`, so one instance can drive many runs (each
run replays the same schedule from the top -- determinism is per-run).

Port of `repro.orchestration.plane`: host Python, no tensor.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.orchestration.churn import JOIN, ChurnSchedule
from repro_torch.orchestration.qos import QoSMonitor
from repro_torch.orchestration.rollout import CANARY, PROMOTED, ROLLED_BACK, RolloutManager


class Orchestrator:
    def __init__(
        self,
        churn: Optional[ChurnSchedule] = None,
        monitor: Optional[QoSMonitor] = None,
        rollout: Optional[RolloutManager] = None,
    ):
        if rollout is not None and monitor is None:
            raise ValueError(
                "a rollout needs a QoS monitor (its trip verdicts are what "
                "gate promotion)"
            )
        self.churn = churn
        self.monitor = monitor
        self.rollout = rollout
        self._cursor = 0
        self._audit = None  # repro_torch.obs.AuditLog, injected via attach

    # ------------------------------------------------------ simulator hooks
    def attach(self, sim, tel, audit=None) -> None:
        n = sim.topology.n_cells
        self._cursor = 0
        self._audit = audit
        if self.churn is not None:
            for ev in self.churn.events:
                if ev.cell >= n:
                    raise ValueError(
                        f"churn event targets cell {ev.cell} in a {n}-cell fleet"
                    )
        if self.monitor is not None:
            self.monitor.reset(n)
        if self.rollout is not None:
            if max(self.rollout.canary_cells) >= n:
                raise ValueError(
                    f"canary cells {self.rollout.canary_cells} exceed the "
                    f"{n}-cell fleet"
                )
            self.rollout.reset()

    def on_window(self, sim, tel, window: int, t0: float) -> None:
        if self.churn is not None:
            due, self._cursor = self.churn.due(self._cursor, t0)
            for ev in due:
                sim.set_active(ev.cell, ev.kind == JOIN)
                tel.record_orchestration(
                    t0, f"churn_{ev.kind}", cell=ev.cell, scheduled_t_s=ev.t_s
                )
                if self._audit is not None:
                    self._audit.record(t0, "churn", f"churn_{ev.kind}",
                                       cell=int(ev.cell),
                                       scheduled_t_s=float(ev.t_s))
        if self.monitor is not None:
            result = self.monitor.observe(tel, t0)
            evidence = result.get("evidence", {})
            for c, metric in result["tripped"]:
                tel.record_orchestration(t0, "qos_trip", cell=int(c), metric=metric)
                if self._audit is not None:
                    self._audit.record(t0, "qos_monitor", "qos_trip",
                                       cell=int(c), **evidence.get(c, {}))
            for c in result["cleared"]:
                tel.record_orchestration(t0, "qos_clear", cell=int(c))
                if self._audit is not None:
                    self._audit.record(t0, "qos_monitor", "qos_clear",
                                       cell=int(c), **evidence.get(c, {}))
        if self.rollout is not None:
            before = self.rollout.state
            self.rollout.step(sim, tel, self.monitor, t0)
            after = self.rollout.state
            if self._audit is not None and after != before:
                rm = self.rollout
                if after == CANARY:
                    self._audit.record(
                        t0, "rollout_manager", "rollout_canary",
                        bank_version=rm.candidate.bank_version,
                        incumbent_version=rm.incumbent_version,
                        cells=list(rm.canary_cells))
                elif after == ROLLED_BACK:
                    self._audit.record(
                        t0, "rollout_manager", "rollout_rollback",
                        bank_version=rm.candidate.bank_version,
                        restored_version=rm.incumbent_version,
                        tripped=list(rm.tripped_canaries))
                elif after == PROMOTED:
                    self._audit.record(
                        t0, "rollout_manager", "rollout_promote",
                        bank_version=rm.candidate.bank_version)

    def finish(self, sim, tel, t_end: float) -> None:
        tel.record_orchestration(
            t_end, "finish",
            active_cells=int(sim.active_mask().sum()),
            shed_requests=int(sim.shed_counts.sum()),
            rollout_state=None if self.rollout is None else self.rollout.state,
        )
