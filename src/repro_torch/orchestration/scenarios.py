"""Adversarial fleet scenarios: the orchestration plane's proving ground.

Each scenario is a seeded, deterministic stressor registered with
`@register_scenario`; `run_scenarios` sweeps them into uniform records
that `benchmarks/run.py --fleet` writes to ``BENCH_fleet.json`` and CI
asserts on. Every record has:

    {"name": ..., "arms": {arm: fleet_summary + extras},
     "wins": {metric: {...,"win": bool}}, "events": {...}, "pass": bool}

where ``pass`` is the AND of the scenario's required wins. The arms are
always a CONTROL (static configuration, or rollout disabled) against the
treatment (fleet controller, or the QoS-gated rollout), on identical
workloads and seeds -- the same controller-vs-static discipline as the
fleet bench, under operations instead of steady load.

The registry is intentionally open: `register_scenario` is public, and a
scenario is any callable ``fn(quick: bool, seed: int, device) -> dict``.

Port of `repro.orchestration.scenarios`. The port's scenarios take the
`device` they run on: `run_scenarios(device=None)` resolves it first
(``cuda``; without a GPU it raises before any data is made), and each
scenario fits its plans there (`fit_drift_plans(device=...)`) and gates
every run, candidate tables included, on one ``"torch"`` gate backend
there. The per-seed data cache holds host numpy only; plans are fit anew
by every scenario, so no run ever serves plans fit on another device.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.bank import PlanBank
from repro_torch.core.calibration import TemperatureScaling
from repro_torch.core.gatepath import TorchGateBackend
from repro_torch.fleet.scenarios import (
    FleetScenario,
    fleet_gate_table,
    reference_fleet,
    run_fleet,
)
from repro_torch.fleet.simulator import FleetConfig
from repro_torch.fleet.topology import CellConfig, CellWorkload, FleetTopology
from repro_torch.obs import AuditLog, Observability
from repro_torch.obs.check import verify_rollback_chain
from repro_torch.orchestration.churn import ChurnSchedule
from repro_torch.orchestration.plane import Orchestrator
from repro_torch.orchestration.qos import CellSLO, QoSConfig, QoSMonitor
from repro_torch.orchestration.rollout import PROMOTED, ROLLED_BACK, RolloutManager
from repro_torch.serving.drift import PiecewiseSchedule
from repro_torch.serving.scenarios import fit_drift_plans, synthetic_distorted_cascade

SCENARIOS: Dict[str, Callable] = {}


def register_scenario(name: str):
    """Register ``fn(quick, seed, device) -> record`` under `name`; later
    registrations override (so downstream code can swap a stressor)."""

    def deco(fn):
        SCENARIOS[name] = fn
        return fn

    return deco


def run_scenarios(
    names: Optional[Sequence[str]] = None,
    quick: bool = False,
    seed: int = 0,
    device=None,
) -> List[dict]:
    """Run the named scenarios (None/"all" -> every registered one, in
    registration order) on `device` -> their records."""
    device = resolve_device(device)
    if names is None:
        picked = list(SCENARIOS)
    else:
        unknown = [n for n in names if n not in SCENARIOS]
        if unknown:
            raise ValueError(
                f"unknown scenario(s) {unknown}; registered: {list(SCENARIOS)}"
            )
        picked = list(names)
    return [SCENARIOS[n](quick=quick, seed=seed, device=device) for n in picked]


# ------------------------------------------------------------ shared pieces
_DATA: Dict[int, tuple] = {}


def _drift_data(seed: int = 0):
    """One (val, test) split per seed, cached: every scenario stresses the
    SAME drift data so their numbers are comparable across the matrix."""
    if seed not in _DATA:
        _DATA[seed] = synthetic_distorted_cascade(
            seed=seed, directions={"gaussian_blur": "under"}
        )
    return _DATA[seed]


def _plans(seed: int = 0, device=None):
    """(uncalibrated, global single, expert bank), fit on `device`."""
    val, test = _drift_data(seed)
    return fit_drift_plans(val, device=device)


def poisoned_bank(bank: PlanBank, temp_scale: float = 0.05) -> PlanBank:
    """A miscalibrated candidate: every expert's temperatures scaled by
    `temp_scale` (T << 1 sharpens softmax -> systematic overconfidence),
    version-bumped so the rollout manager accepts it. The poison is
    exactly the failure mode the paper calibrates away, injected as an
    artifact a fleet might actually ship."""
    if temp_scale <= 0:
        raise ValueError("temp_scale must be positive")
    plans = {
        k: p._copy(
            calibrators=[
                TemperatureScaling.from_temperature(t * temp_scale)
                for t in p.temperatures
            ]
        )
        for k, p in bank.plans.items()
    }
    return PlanBank(
        plans=plans,
        default_context=bank.default_context,
        estimator=bank.estimator,
        metadata={**bank.metadata, "poisoned": True},
        bank_version=bank.bank_version + 1,
    )


def _summary(tel) -> dict:
    s = tel.fleet_summary()
    return {k: (float(v) if isinstance(v, float) else v) for k, v in s.items()}


def _win(wins: dict, metric: str, treatment: dict, control: dict,
         margin: float = 1.0) -> bool:
    """Record a lower-is-better win on `metric` (treatment must beat
    control by the multiplicative margin) -> the verdict."""
    t, c = treatment[metric], control[metric]
    ok = bool(np.isfinite(t) and np.isfinite(c) and t < c * margin)
    wins[metric] = {"treatment": t, "control": c, "margin": margin, "win": ok}
    return ok


def _record(name: str, arms: dict, wins: dict, events: dict,
            passed: bool) -> dict:
    return {"name": name, "arms": arms, "wins": wins, "events": events,
            "pass": bool(passed)}


def _quick_size(quick: bool) -> dict:
    return dict(
        n_cells=8,
        requests_per_cell=300 if quick else 700,
        cloud_servers=2,
    )


# --------------------------------------------------------------- scenarios
@register_scenario("weather_front")
def weather_front(quick: bool = False, seed: int = 0, device=None) -> dict:
    """Correlated cross-cell drift: a contrast front sweeps the ring, each
    cell entering the overconfident regime a beat after its neighbor --
    the spatially-correlated version of the drift the bank was built for.
    Control: the paper's single global plan (clean-fit temperatures),
    static. Treatment: expert bank + fleet controller. Required win:
    reliability gap (the front breaks the clean-fit gate's contract in
    every cell it crosses)."""
    val, test = _drift_data(seed)
    _, global_plan, bank = _plans(seed, device)
    gate = TorchGateBackend(device=device)
    size = _quick_size(quick)
    base = reference_fleet(seed=seed, val=val, test=test, **size)
    # same workloads/links, but the Markov weather is replaced by one
    # deterministic front: cell i is distorted during [6 + 1.5 i, 18 + 1.5 i)
    cells = []
    for i, cell in enumerate(base.topology.cells):
        front = PiecewiseSchedule([
            (0.0, "clean"),
            (6.0 + 1.5 * i, "contrast@4"),
            (18.0 + 1.5 * i, "clean"),
        ])
        cells.append(CellConfig(
            network=cell.network, workload=cell.workload,
            n_devices=cell.n_devices, schedule=front,
            deadline_s=cell.deadline_s,
        ))
    scn = FleetScenario(
        topology=FleetTopology(cells, cloud_servers=size["cloud_servers"]),
        val=val, test=test, contexts=base.contexts,
    )
    control = _summary(run_fleet(global_plan, scn, backend=gate))
    treatment = _summary(run_fleet(bank, scn, with_controller=True, backend=gate))
    wins: dict = {}
    ok = _win(wins, "miscalibration_gap", treatment, control)
    _win(wins, "p99_ms", treatment, control)  # recorded, not required
    return _record(
        "weather_front",
        {"static_global": control, "bank_controller": treatment},
        wins, {"front_span_s": [6.0, 18.0 + 1.5 * (size["n_cells"] - 1)]}, ok,
    )


def _burst_workload(
    rate_hz: float, burst_rate_hz: float, burst: tuple,
    n_requests: int, n_samples: int, n_devices: int, seed: int,
) -> CellWorkload:
    """Poisson arrivals at `rate_hz`, spiking to `burst_rate_hz` inside
    the `burst` = (start_s, end_s) interval -- a piecewise-homogeneous
    process materialized gap by gap, deterministic under the seed."""
    rng = np.random.default_rng(seed)
    a, b = burst
    t, arrivals = 0.0, np.empty(n_requests, np.float64)
    for i in range(n_requests):
        r = burst_rate_hz if a <= t < b else rate_hz
        t += float(rng.exponential(1.0 / r))
        arrivals[i] = t
    idx = np.arange(n_requests, dtype=np.int64)
    return CellWorkload(arrivals, idx % n_samples, idx % n_devices)


@register_scenario("flash_crowd")
def flash_crowd(quick: bool = False, seed: int = 0, device=None) -> dict:
    """Fleet-wide arrival spike: every cell's rate jumps 5x for ten
    seconds (think a broadcast event). Control: the expert bank, static
    deployment. Treatment: the same bank + fleet controller, which can
    concede p_tar / move branches where the spike saturates a link.
    Required win: p99 latency."""
    val, test = _drift_data(seed)
    _, _, bank = _plans(seed, device)
    gate = TorchGateBackend(device=device)
    size = _quick_size(quick)
    base = reference_fleet(seed=seed, val=val, test=test, **size)
    n_samples = len(test["labels"])
    burst = (8.0, 18.0)
    cells = []
    for i, cell in enumerate(base.topology.cells):
        wl = _burst_workload(
            20.0, 100.0, burst, size["requests_per_cell"], n_samples,
            cell.n_devices, seed + 300 + i,
        )
        cells.append(CellConfig(
            network=cell.network, workload=wl, n_devices=cell.n_devices,
            schedule=cell.schedule, deadline_s=cell.deadline_s,
        ))
    scn = FleetScenario(
        topology=FleetTopology(cells, cloud_servers=size["cloud_servers"]),
        val=val, test=test, contexts=base.contexts,
    )
    control = _summary(run_fleet(bank, scn, backend=gate))
    treatment = _summary(run_fleet(bank, scn, with_controller=True, backend=gate))
    wins: dict = {}
    ok = _win(wins, "p99_ms", treatment, control)
    _win(wins, "miscalibration_gap", treatment, control, margin=1.5)
    return _record(
        "flash_crowd",
        {"bank_static": control, "bank_controller": treatment},
        wins, {"burst_s": list(burst), "burst_rate_x": 5.0}, ok,
    )


@register_scenario("link_outage")
def link_outage(quick: bool = False, seed: int = 0, device=None) -> dict:
    """Churn: a quarter of the cells fail mid-run and recover ten seconds
    later; their load sheds onto ring neighbors, doubling the hosts'
    demand. Both arms run the SAME outage through the orchestrator;
    treatment adds the fleet controller (whose utilization estimate sees
    the shed arrivals). Required win: p99 latency. Also asserts request
    conservation -- every shed request is still served and attributed."""
    val, test = _drift_data(seed)
    _, _, bank = _plans(seed, device)
    gate = TorchGateBackend(device=device)
    size = _quick_size(quick)
    scn = reference_fleet(seed=seed, val=val, test=test, **size)
    down = list(range(0, size["n_cells"], 4))
    churn = ChurnSchedule.outage(down, start_s=8.0, duration_s=10.0)

    tel_c = run_fleet(bank, scn, orchestrator=Orchestrator(churn=churn), backend=gate)
    tel_t = run_fleet(
        bank, scn, with_controller=True, orchestrator=Orchestrator(churn=churn),
        backend=gate,
    )
    control, treatment = _summary(tel_c), _summary(tel_t)
    conserved = (
        tel_c.requests() == scn.topology.n_requests
        and tel_t.requests() == scn.topology.n_requests
    )
    wins: dict = {}
    ok = _win(wins, "p99_ms", treatment, control) and conserved
    _win(wins, "miscalibration_gap", treatment, control, margin=1.5)
    finish = [e for e in tel_t.orchestration_events if e[1] == "finish"][0]
    return _record(
        "link_outage",
        {"bank_static": control, "bank_controller": treatment},
        wins,
        {"down_cells": down, "outage_s": [8.0, 18.0],
         "shed_requests": int(finish[2]["shed_requests"]),
         "requests_conserved": conserved},
        ok,
    )


@register_scenario("cloud_brownout")
def cloud_brownout(quick: bool = False, seed: int = 0, device=None) -> dict:
    """The shared cloud tier loses most of its capacity for a stretch
    (service times x6 for jobs landing in the interval). Control: the
    conventional uncalibrated plan, static. Treatment: expert bank +
    controller. Required win: reliability gap -- during a brownout the
    cloud stops being an escape hatch, so what the edge answers on-device
    had better honor p_tar, which is exactly what calibration buys."""
    val, test = _drift_data(seed)
    uncal, _, bank = _plans(seed, device)
    gate = TorchGateBackend(device=device)
    size = _quick_size(quick)
    scn = reference_fleet(seed=seed, val=val, test=test, **size)
    brown = (8.0, 20.0, 6.0)
    cfg = FleetConfig(window_s=0.5, cloud_slowdowns=(brown,))
    control = _summary(run_fleet(uncal, scn, fleet_config=cfg, backend=gate))
    treatment = _summary(
        run_fleet(bank, scn, with_controller=True, fleet_config=cfg, backend=gate)
    )
    wins: dict = {}
    ok = _win(wins, "miscalibration_gap", treatment, control)
    _win(wins, "deadline_miss_rate", treatment, control, margin=1.5)
    return _record(
        "cloud_brownout",
        {"static_uncalibrated": control, "bank_controller": treatment},
        wins, {"brownout": list(brown)}, ok,
    )


def _rollout_pieces(scn: FleetScenario, candidate: PlanBank,
                    incumbent_version: int = 0,
                    slo: Optional[CellSLO] = None, backend=None):
    """The shared canary wiring: watch the reliability SHORTFALL per cell
    (accuracy below the promised p_tar; over-delivery never trips) with
    hysteresis, canary on two cells, promote after 8 clear windows. The
    gate-sample floor is what separates the honest bank (offloads its
    hard traffic, few on-device outcomes per window) from the poisoned
    one (overconfident, keeps everything, floods the audit stream).
    `slo` overrides the default shortfall SLO (e.g. to add the
    calibration-health caps, `CellSLO.ece_cap`/`coverage_floor`)."""
    monitor = QoSMonitor(
        slo if slo is not None else CellSLO(
            reliability_shortfall=0.12, min_requests=12,
            min_gate_samples=25,
        ),
        QoSConfig(window_s=3.0, trip_after=2, clear_after=4),
    )
    rollout = RolloutManager(
        candidate,
        table_factory=lambda b: fleet_gate_table(b, scn, backend=backend),
        canary_cells=(0, 1),
        promote_after=8,
        start_at_s=4.0,
        incumbent_version=incumbent_version,
    )
    return Orchestrator(monitor=monitor, rollout=rollout), monitor, rollout


@register_scenario("poisoned_canary")
def poisoned_canary(quick: bool = False, seed: int = 0, device=None) -> dict:
    """A new bank ships with catastrophically sharpened temperatures
    (T x0.05: systematic overconfidence). Guarded arm: the rollout
    manager canaries it on two cells; their on-device reliability gap
    blows the SLO, the monitor trips, and the fleet rolls back to the
    incumbent. Unguarded arm: the same bank promoted fleet-wide
    immediately. Required: the rollback happens, the guarded fleet's
    gap stays within 1.5x the incumbent's while the unguarded one does
    not, AND the whole trip -> rollback causal chain reconstructs from
    the guarded arm's decision audit log alone
    (`repro_torch.obs.check.verify_rollback_chain`)."""
    val, test = _drift_data(seed)
    _, _, bank = _plans(seed, device)
    gate = TorchGateBackend(device=device)
    size = _quick_size(quick)
    scn = reference_fleet(seed=seed, val=val, test=test, **size)
    bad = poisoned_bank(bank)
    orch, monitor, rollout = _rollout_pieces(scn, bad, backend=gate)
    audit = AuditLog()

    incumbent = _summary(run_fleet(bank, scn, backend=gate))
    guarded = _summary(
        run_fleet(bank, scn, orchestrator=orch, obs=Observability(audit=audit),
                  backend=gate)
    )
    unguarded = _summary(run_fleet(bad, scn, backend=gate))

    chain = verify_rollback_chain(audit.records)
    rolled_back = rollout.state == ROLLED_BACK
    gap_i = incumbent["miscalibration_gap"]
    gap_g = guarded["miscalibration_gap"]
    gap_u = unguarded["miscalibration_gap"]
    contained = bool(np.isfinite(gap_g) and gap_g <= 1.5 * gap_i)
    damage_shown = bool(np.isfinite(gap_u) and gap_u > 1.5 * gap_i)
    wins = {
        "rolled_back": {"win": rolled_back,
                        "at_s": rollout.rolled_back_at,
                        "tripped_canaries": rollout.tripped_canaries},
        "gap_contained": {"incumbent": gap_i, "guarded": gap_g,
                          "unguarded": gap_u, "cap": 1.5 * gap_i,
                          "win": contained and damage_shown},
        "audit_chain": {"win": chain["ok"], "why": chain["why"]},
    }
    ok = rolled_back and contained and damage_shown and chain["ok"]
    return _record(
        "poisoned_canary",
        {"incumbent": incumbent, "guarded_rollout": guarded,
         "unguarded_rollout": unguarded},
        wins,
        {"trips": [(t, int(c), m) for t, c, m in monitor.trip_log],
         "rollout_state": rollout.state,
         "candidate_version": bad.bank_version,
         "audit_records": len(audit)},
        ok,
    )


@register_scenario("good_rollout")
def good_rollout(quick: bool = False, seed: int = 0, device=None) -> dict:
    """The happy path: the candidate is the incumbent bank re-minted at
    the next version (identical calibration). The canary stays clear for
    the full probation, the rollout PROMOTES fleet-wide, and -- because
    the candidate gates identically -- the orchestrated run reproduces
    the incumbent run's fleet metrics to float round-off. Promotion of a
    good bank must be a no-op; anything else is the rollout machinery
    itself distorting service."""
    val, test = _drift_data(seed)
    _, _, bank = _plans(seed, device)
    gate = TorchGateBackend(device=device)
    size = _quick_size(quick)
    scn = reference_fleet(seed=seed, val=val, test=test, **size)
    candidate = bank.bumped()
    orch, monitor, rollout = _rollout_pieces(scn, candidate, backend=gate)

    incumbent = _summary(run_fleet(bank, scn, backend=gate))
    promoted_run = _summary(run_fleet(bank, scn, orchestrator=orch, backend=gate))

    promoted = rollout.state == PROMOTED
    close = all(
        (math.isnan(incumbent[k]) and math.isnan(promoted_run[k]))
        or abs(incumbent[k] - promoted_run[k])
        <= 1e-9 * max(1.0, abs(incumbent[k]))
        for k in ("p99_ms", "miscalibration_gap", "deadline_miss_rate",
                  "offload_rate", "accuracy")
    )
    wins = {
        "promoted": {"win": promoted, "at_s": rollout.promoted_at},
        "no_op_promotion": {"win": close},
    }
    ok = promoted and close and not monitor.trip_log
    return _record(
        "good_rollout",
        {"incumbent": incumbent, "promoted_rollout": promoted_run},
        wins,
        {"promoted_at_s": rollout.promoted_at,
         "candidate_version": candidate.bank_version,
         "trips": len(monitor.trip_log)},
        ok,
    )
