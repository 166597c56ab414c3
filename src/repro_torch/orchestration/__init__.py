"""Live orchestration plane over the fleet simulator (port of
`repro.orchestration`).

The fleet of `repro_torch.fleet` survives load; this package makes it
survive *operations*. An `Orchestrator` rides the simulator's window loop
and drives three event sources against it:

* `churn`    -- `ChurnSchedule`: seeded join/leave events flip per-cell
               activation mid-run; a dead cell's arrivals shed to the
               nearest live ring neighbor (or the cloud backhaul);
* `qos`      -- `QoSMonitor`: per-cell trailing-window p99 / deadline-miss
               / reliability-gap checks against a declared `CellSLO`,
               with trip/clear hysteresis, fed from the simulator's LIVE
               completion view;
* `rollout`  -- `RolloutManager`: a versioned `PlanBank` candidate
               canaries on k cells and promotes fleet-wide only after m
               consecutive clear QoS windows -- any canary trip rolls the
               fleet back to the incumbent;
* `scenarios`-- the `@register_scenario` registry of adversarial
               stressors (weather fronts, flash crowds, link outages,
               cloud brownouts, poisoned canaries).

Everything is seeded and deterministic: the same schedule, SLO, and
candidate bank replay the same trips, rollbacks, and telemetry. With no
churn events and no rollout the orchestrated simulator is bit-identical
to the unorchestrated one (the final metrics still come from the exact
deferred cloud solve; the live view only feeds the monitor).

The plane is host Python; the scenarios run their fits and gates on the
`device` they are given (the card unless the caller names the CPU).
"""
from repro_torch.orchestration.churn import JOIN, LEAVE, ChurnEvent, ChurnSchedule
from repro_torch.orchestration.plane import Orchestrator
from repro_torch.orchestration.qos import CellSLO, QoSConfig, QoSMonitor
from repro_torch.orchestration.rollout import (
    CANARY,
    IDLE,
    PROMOTED,
    ROLLED_BACK,
    RolloutManager,
)
from repro_torch.orchestration.scenarios import (
    SCENARIOS,
    poisoned_bank,
    register_scenario,
    run_scenarios,
)

__all__ = [
    "JOIN",
    "LEAVE",
    "ChurnEvent",
    "ChurnSchedule",
    "Orchestrator",
    "CellSLO",
    "QoSConfig",
    "QoSMonitor",
    "IDLE",
    "CANARY",
    "PROMOTED",
    "ROLLED_BACK",
    "RolloutManager",
    "SCENARIOS",
    "poisoned_bank",
    "register_scenario",
    "run_scenarios",
]
