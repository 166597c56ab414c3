"""Port parity for the orchestration plane (`repro_torch.orchestration`:
churn, qos, rollout, plane, scenarios) against `repro.orchestration` on
the CPU: every non-slow case of tests/test_orchestration.py run on the
port (the `fleet.gate` shim included), and the same orchestrated fleets
and quick adversarial scenarios run through both packages, record by
record.

The plans are the reference's fit, carried over as JSON (ROADMAP hazard
c); the scenarios' own fits are swapped for them where both packages run
the same scenario.

Tolerances: decision-derived numbers, event logs and trip logs equal;
latencies rel 1e-9; confidence-derived numbers (the windowed ECE, the
reliability bins' mean confidence and residual) rel 2e-5 / abs 1e-6
(hazard h). Records are compared field by field, never as
whole JSON dumps.
"""
import json
import math
import warnings

import numpy as np
import pytest

from repro.fleet.scenarios import reference_fleet as jreference_fleet
from repro.fleet.scenarios import run_fleet as jrun_fleet
from repro.orchestration import CellSLO as JSLO
from repro.orchestration import ChurnSchedule as JChurn
from repro.orchestration import Orchestrator as JOrchestrator
from repro.orchestration import QoSConfig as JQoSConfig
from repro.orchestration import QoSMonitor as JQoSMonitor
from repro.orchestration import scenarios as jscen
from repro.serving import scenarios as jscn
from repro_torch.core.bank import PlanBank
from repro_torch.core.gatepath import TorchGateBackend
from repro_torch.core.policy import OffloadPlan
from repro_torch.fleet.scenarios import fleet_gate_table, reference_fleet, run_fleet
from repro_torch.fleet.topology import (
    CellConfig,
    DiurnalEnvelope,
    FleetTopology,
    poisson_cell_workload,
)
from repro_torch.orchestration import (
    JOIN,
    LEAVE,
    SCENARIOS,
    CellSLO,
    ChurnEvent,
    ChurnSchedule,
    Orchestrator,
    QoSConfig,
    QoSMonitor,
    RolloutManager,
    poisoned_bank,
    register_scenario,
    run_scenarios,
)
from repro_torch.orchestration import scenarios as tscen
from repro_torch.orchestration.rollout import CANARY, IDLE, PROMOTED, ROLLED_BACK
from repro_torch.serving import scenarios as tscn
from repro_torch.serving.drift import MarkovContextSchedule
from repro_torch.serving.network import FixedRateNetwork

TORCH_CPU = TorchGateBackend(device="cpu")
CONF_TOL = dict(rel=2e-5, abs=1e-6)


#: numbers computed from gate confidences: the windowed ECE and the
#: reliability bins' mean confidence and residual
CONF_KEYS = ("ece", "mean_conf", "residual")


def same_value(a, b, key=""):
    """Recursive equality: nan matches nan, latencies (``*_ms`` keys and
    the p99 wins' control / treatment) to rel 1e-9, confidence-derived
    numbers (`CONF_KEYS`) to the gate tolerance."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (key, a, b)
        for k in a:
            same_value(a[k], b[k], k)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (key, a, b)
        for x, y in zip(a, b):
            same_value(x, y, key)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), (key, a, b)
    elif isinstance(a, float) and key in CONF_KEYS:
        assert a == pytest.approx(b, **CONF_TOL), (key, a, b)
    elif isinstance(a, float) and ("_ms" in key or key in ("control", "treatment")):
        assert a == pytest.approx(b, rel=1e-9, abs=0), (key, a, b)
    else:
        assert a == b, (key, a, b)


@pytest.fixture(scope="module")
def drift_data():
    """The fleet bench's data and the reference's plans, as JSON."""
    val, test = tscn.synthetic_distorted_cascade(directions={"gaussian_blur": "under"})
    jplans = jscn.fit_drift_plans(val)
    plans = tuple((PlanBank if i == 2 else OffloadPlan).from_json(p.to_json())
                  for i, p in enumerate(jplans))
    return val, test, plans, jplans


def small_fleet(drift_data, seed=0, n_cells=6, requests_per_cell=200, ref=False):
    val, test = drift_data[:2]
    make = jreference_fleet if ref else reference_fleet
    return make(n_cells=n_cells, requests_per_cell=requests_per_cell, seed=seed,
                val=val, test=test, cloud_servers=2)


# ------------------------------------------------------------ churn engine
def test_churn_event_validation():
    with pytest.raises(ValueError, match="kind"):
        ChurnEvent(1.0, 0, "reboot")
    with pytest.raises(ValueError, match="t_s"):
        ChurnEvent(-1.0, 0, JOIN)
    with pytest.raises(ValueError, match="cell"):
        ChurnEvent(1.0, -1, LEAVE)


def test_churn_schedule_sorted_and_cursor():
    sched = ChurnSchedule([
        ChurnEvent(5.0, 1, LEAVE),
        ChurnEvent(1.0, 0, LEAVE),
        ChurnEvent(3.0, 0, JOIN),
        # same-instant bounce on cell 2: join sorts BEFORE leave
        ChurnEvent(2.0, 2, LEAVE),
        ChurnEvent(2.0, 2, JOIN),
    ])
    times = [e.t_s for e in sched.events]
    assert times == sorted(times)
    assert [e.kind for e in sched.events if e.t_s == 2.0] == [JOIN, LEAVE]
    due, cur = sched.due(0, 2.0)
    assert [e.t_s for e in due] == [1.0, 2.0, 2.0]
    again, _ = sched.due(0, 2.0)
    assert again == due
    due2, cur = sched.due(cur, 10.0)
    assert [e.t_s for e in due2] == [3.0, 5.0]
    assert cur == len(sched)


def test_churn_outage_and_random_deterministic():
    """Outage and seeded random schedules, the latter event for event the
    reference's under the same seed."""
    out = ChurnSchedule.outage([0, 2], start_s=4.0, duration_s=3.0)
    assert len(out) == 4
    assert {(e.cell, e.kind) for e in out.events if e.t_s == 4.0} == {(0, LEAVE), (2, LEAVE)}
    assert {(e.cell, e.kind) for e in out.events if e.t_s == 7.0} == {(0, JOIN), (2, JOIN)}
    with pytest.raises(ValueError, match="duration"):
        ChurnSchedule.outage([0], 1.0, 0.0)
    a = ChurnSchedule.random(16, 200.0, seed=3)
    b = ChurnSchedule.random(16, 200.0, seed=3)
    assert a.events == b.events
    assert len(a) > 0
    assert all(e.t_s < 200.0 for e in a.events)
    c = ChurnSchedule.random(16, 200.0, seed=4)
    assert c.events != a.events
    ref = JChurn.random(16, 200.0, seed=3)
    assert [(e.t_s, e.cell, e.kind) for e in a.events] == \
        [(e.t_s, e.cell, e.kind) for e in ref.events]


def test_shed_order_ring_geometry():
    wl = poisson_cell_workload(10.0, 20, 64)
    topo = FleetTopology([CellConfig(network=FixedRateNetwork(1e7), workload=wl)
                          for _ in range(6)])
    assert list(topo.shed_order(0)) == [1, 5, 2, 4, 3]
    assert list(topo.shed_order(3)) == [2, 4, 1, 5, 0]
    assert 2 not in topo.shed_order(2)


# -------------------------------------------------------------- QoS monitor
def test_slo_validation():
    with pytest.raises(ValueError, match="at least one"):
        CellSLO()
    with pytest.raises(ValueError, match="min_requests"):
        CellSLO(p99_ms=100.0, min_requests=0)
    with pytest.raises(ValueError, match="trip_after"):
        QoSConfig(trip_after=0)


def _qos(requests=100, gate_samples=100, p99=10.0, miss=0.0, gap=0.0, short=0.0):
    return {
        "requests": requests, "gate_samples": gate_samples, "p99_ms": p99,
        "deadline_miss_rate": miss, "reliability_gap": gap, "reliability_shortfall": short,
    }


def test_violation_evidence_gating():
    mon = QoSMonitor(CellSLO(p99_ms=50.0, reliability_shortfall=0.1,
                             min_requests=20, min_gate_samples=30))
    assert mon.violation(_qos()) == ""
    assert mon.violation(_qos(p99=80.0)) == "p99_ms"
    assert mon.violation(_qos(short=0.2)) == "reliability_shortfall"
    assert mon.violation(_qos(requests=5, p99=500.0)) == ""
    assert mon.violation(_qos(requests=5, p99=500.0, short=0.2)) == "reliability_shortfall"
    assert mon.violation(_qos(gate_samples=10, short=0.9)) == ""
    assert mon.violation(_qos(requests=5, gate_samples=10, p99=500.0, short=0.9)) is None
    assert mon.violation(_qos(p99=float("nan"))) == ""
    gapped = QoSMonitor(CellSLO(reliability_gap=0.1))
    assert gapped.violation(_qos(gap=0.2, short=0.0)) == "reliability_gap"
    shortfall = QoSMonitor(CellSLO(reliability_shortfall=0.1))
    assert shortfall.violation(_qos(gap=0.2, short=0.0)) == ""


class _ScriptedTel:
    """cell_qos_estimate scripted per cell as a list of window dicts."""

    def __init__(self, script):
        self.script = script
        self.calls = {c: 0 for c in script}

    def cell_qos_estimate(self, cell, window_s, now):
        i = min(self.calls[cell], len(self.script[cell]) - 1)
        self.calls[cell] += 1
        return self.script[cell][i]


def test_qos_hysteresis_trip_and_clear():
    bad, good = _qos(p99=200.0), _qos()
    none = _qos(requests=0, gate_samples=0)
    tel = _ScriptedTel({0: [bad, bad, none, bad, good, good, good, good]})
    mon = QoSMonitor(CellSLO(p99_ms=50.0), QoSConfig(trip_after=3, clear_after=2))
    mon.reset(1)
    events = []
    for t in range(8):
        events.append(mon.observe(tel, float(t)))
        if t == 2:
            assert mon._bad[0] == 2 and not mon.is_tripped(0)
    assert not events[0]["tripped"] and not events[1]["tripped"]
    assert not events[2]["tripped"]
    assert events[3]["tripped"] == [(0, "p99_ms")]
    assert list(mon.tripped_cells()) == []
    assert not events[4]["cleared"]
    assert events[5]["cleared"] == [0]
    assert not mon.is_tripped(0)
    assert mon.trip_log == [(3.0, 0, "p99_ms")]
    assert mon.clear_log == [(5.0, 0)]


def test_qos_evidence_floor_alternation_freezes_not_resets():
    """A window under the evidence floor neither advances nor resets the
    trip streak; judged clean, the same window resets it."""
    bad = _qos(p99=200.0)
    thin_clean = _qos(requests=5, p99=10.0)
    mon = QoSMonitor(CellSLO(p99_ms=50.0, min_requests=20),
                     QoSConfig(trip_after=2, clear_after=2))
    mon.reset(1)
    tel = _ScriptedTel({0: [bad, thin_clean, bad]})
    verdicts = [mon.observe(tel, float(t))["tripped"] for t in range(3)]
    assert verdicts == [[], [], [(0, "p99_ms")]]
    assert mon._bad[0] == 2
    mon2 = QoSMonitor(CellSLO(p99_ms=50.0, min_requests=1),
                      QoSConfig(trip_after=2, clear_after=2))
    mon2.reset(1)
    tel2 = _ScriptedTel({0: [bad, thin_clean] * 6})
    for t in range(12):
        assert not mon2.observe(tel2, float(t))["tripped"]
    assert mon2._bad[0] <= 1


def test_qos_alternating_evidence_freezes_clear_streak():
    """A tripped cell cannot clear through no-evidence windows."""
    bad, good = _qos(p99=200.0), _qos()
    thin = _qos(requests=0, gate_samples=0)
    script = [bad, bad] + [good, thin] * 3
    tel = _ScriptedTel({0: script})
    mon = QoSMonitor(CellSLO(p99_ms=50.0), QoSConfig(trip_after=2, clear_after=3))
    mon.reset(1)
    cleared_at = None
    for t in range(len(script)):
        if mon.observe(tel, float(t))["cleared"]:
            cleared_at = t
    assert mon.trip_log == [(1.0, 0, "p99_ms")]
    assert cleared_at == 6


def test_qos_per_metric_evidence_floors_with_hysteresis():
    gate_rich = _qos(requests=2, gate_samples=100, p99=999.0, short=0.5)
    tel = _ScriptedTel({0: [gate_rich, gate_rich]})
    mon = QoSMonitor(CellSLO(p99_ms=50.0, reliability_shortfall=0.1,
                             min_requests=20, min_gate_samples=30),
                     QoSConfig(trip_after=2, clear_after=2))
    mon.reset(1)
    assert mon.observe(tel, 0.0)["tripped"] == []
    assert mon.observe(tel, 1.0)["tripped"] == [(0, "reliability_shortfall")]
    assert mon.trip_log[0][2] == "reliability_shortfall"


def test_qos_trip_evidence_payload():
    bad = _qos(p99=200.0)
    tel = _ScriptedTel({0: [bad, bad]})
    mon = QoSMonitor(CellSLO(p99_ms=50.0), QoSConfig(trip_after=2))
    mon.reset(1)
    mon.observe(tel, 0.0)
    ev = mon.observe(tel, 1.0)["evidence"][0]
    assert ev["metric"] == "p99_ms" and ev["value"] == 200.0
    assert ev["cap"] == 50.0 and ev["bad_streak"] == 2
    assert ev["requests"] == 100
    mask = mon.tripped_mask()
    assert mask.dtype == bool and mask[0]
    mask[0] = False
    assert mon.is_tripped(0)  # a copy: callers cannot reach in


def test_qos_watched_subset():
    bad = _qos(p99=200.0)
    tel = _ScriptedTel({0: [bad], 1: [bad]})
    mon = QoSMonitor(CellSLO(p99_ms=50.0), QoSConfig(trip_after=1), cells=[1])
    mon.reset(2)
    assert mon.observe(tel, 0.0)["tripped"] == [(1, "p99_ms")]
    assert tel.calls[0] == 0


# ---------------------------------------------------------- rollout manager
class _FakeSim:
    def __init__(self, n_cells):
        class T:
            pass

        self.topology = T()
        self.topology.n_cells = n_cells
        self.tables = {}

    def set_cell_table(self, c, table):
        self.tables[c] = table


class _FakeTel:
    def __init__(self):
        self.events = []

    def record_orchestration(self, t, kind, **payload):
        self.events.append((t, kind, payload))


class _FakeMonitor:
    def __init__(self):
        self.bad = set()

    def is_tripped(self, c):
        return c in self.bad


def test_rollout_requires_monotonic_version(drift_data):
    bank = drift_data[2][2]
    assert bank.bank_version == 0
    with pytest.raises(ValueError, match="monotonic"):
        RolloutManager(bank, lambda b: b, canary_cells=(0,))
    b1 = bank.bumped()
    assert b1.bank_version == 1
    assert b1.bumped(7).bank_version == 7
    with pytest.raises(ValueError, match="increase"):
        b1.bumped(1)
    with pytest.raises(ValueError, match="canary"):
        RolloutManager(b1, lambda b: b, canary_cells=())
    with pytest.raises(ValueError, match="monotonic"):
        RolloutManager(b1.bumped(3), lambda b: b, canary_cells=(0,), incumbent_version=3)


def test_rollout_promotes_after_clear_probation(drift_data):
    bank = drift_data[2][2].bumped()
    sim, tel, mon = _FakeSim(4), _FakeTel(), _FakeMonitor()
    ro = RolloutManager(bank, lambda b: ("table", b.bank_version),
                        canary_cells=(0, 2), promote_after=3, start_at_s=2.0)
    ro.step(sim, tel, mon, 1.0)
    assert ro.state == IDLE and not sim.tables
    ro.step(sim, tel, mon, 2.0)
    assert ro.state == CANARY and ro.started_at == 2.0
    assert sim.tables == {0: ("table", 1), 2: ("table", 1)}
    ro.step(sim, tel, mon, 3.0)
    ro.step(sim, tel, mon, 4.0)
    assert ro.state == CANARY
    ro.step(sim, tel, mon, 5.0)
    assert ro.state == PROMOTED and ro.promoted_at == 5.0
    assert set(sim.tables) == {0, 1, 2, 3}
    assert [k for _, k, _ in tel.events] == ["rollout_canary", "rollout_promote"]


def test_rollout_rolls_back_on_canary_trip(drift_data):
    bank = drift_data[2][2].bumped()
    sim, tel, mon = _FakeSim(4), _FakeTel(), _FakeMonitor()
    ro = RolloutManager(bank, lambda b: "cand", canary_cells=(0, 2), promote_after=10,
                        start_at_s=0.0)
    ro.step(sim, tel, mon, 0.0)
    assert ro.state == CANARY
    mon.bad = {2}
    ro.step(sim, tel, mon, 1.0)
    assert ro.state == ROLLED_BACK and ro.rolled_back_at == 1.0
    assert ro.tripped_canaries == [2]
    assert sim.tables == {0: None, 2: None}
    mon.bad = set()
    ro.step(sim, tel, mon, 2.0)
    assert ro.state == ROLLED_BACK
    assert [k for _, k, _ in tel.events] == ["rollout_canary", "rollout_rollback"]


def test_orchestrator_validation(drift_data):
    ro = RolloutManager(drift_data[2][2].bumped(), lambda b: b, canary_cells=(5,))
    with pytest.raises(ValueError, match="monitor"):
        Orchestrator(rollout=ro)


# ------------------------------------------------------------- no-op limits
def test_orchestrated_noop_is_bit_exact(drift_data):
    """An attached orchestrator with nothing to do moves no bit of the
    fleet summary, plain or with the controller in the loop."""
    bank = drift_data[2][2]
    scn = small_fleet(drift_data)
    plain = run_fleet(bank, scn, backend=TORCH_CPU).fleet_summary()
    noop = run_fleet(bank, scn, orchestrator=Orchestrator(), backend=TORCH_CPU).fleet_summary()
    assert plain == noop
    ctrl = run_fleet(bank, scn, with_controller=True, backend=TORCH_CPU).fleet_summary()
    ctrl_noop = run_fleet(bank, scn, with_controller=True, orchestrator=Orchestrator(),
                          backend=TORCH_CPU).fleet_summary()
    assert ctrl == ctrl_noop


def test_orchestrated_run_is_deterministic(drift_data):
    bank = drift_data[2][2]
    scn = small_fleet(drift_data)
    churn = ChurnSchedule.outage([0, 3], start_s=3.0, duration_s=4.0)

    def go():
        return run_fleet(bank, scn, with_controller=True,
                         orchestrator=Orchestrator(churn=churn), backend="numpy")

    assert go().fleet_summary() == go().fleet_summary()


# ------------------------------------------------------- churn through sim
def test_outage_sheds_conserves_and_records(drift_data):
    bank = drift_data[2][2]
    scn = small_fleet(drift_data)
    churn = ChurnSchedule.outage([0, 3], start_s=3.0, duration_s=4.0)
    tel = run_fleet(bank, scn, orchestrator=Orchestrator(churn=churn), backend=TORCH_CPU)
    assert tel.requests() == scn.topology.n_requests
    for c in range(scn.topology.n_cells):
        assert len(tel._cells[c].column("latency_s")) == len(scn.topology.cells[c].workload)
    kinds = [k for _, k, _ in tel.orchestration_events]
    assert kinds.count("churn_leave") == 2
    assert kinds.count("churn_join") == 2
    finish = [e for e in tel.orchestration_events if e[1] == "finish"][0]
    assert finish[2]["shed_requests"] > 0
    assert finish[2]["active_cells"] == scn.topology.n_cells
    plain = run_fleet(bank, scn, backend=TORCH_CPU)
    assert tel.fleet_summary()["p99_ms"] >= plain.fleet_summary()["p99_ms"]


def test_whole_fleet_down_backhauls_to_cloud(drift_data):
    bank = drift_data[2][2]
    scn = small_fleet(drift_data, n_cells=2, requests_per_cell=120)
    churn = ChurnSchedule.outage([0, 1], start_s=1.0, duration_s=2.0)
    tel = run_fleet(bank, scn, orchestrator=Orchestrator(churn=churn), backend="numpy")
    assert tel.requests() == scn.topology.n_requests
    assert tel.fleet_summary()["offload_rate"] > run_fleet(
        bank, scn, backend="numpy").fleet_summary()["offload_rate"]


def test_churn_event_out_of_range_rejected(drift_data):
    bank = drift_data[2][2]
    scn = small_fleet(drift_data, n_cells=2, requests_per_cell=50)
    churn = ChurnSchedule([ChurnEvent(1.0, 9, LEAVE)])
    with pytest.raises(ValueError, match="cell 9"):
        run_fleet(bank, scn, orchestrator=Orchestrator(churn=churn), backend="numpy")


# ------------------------------------------------- canary, both directions
def _rollout(scn, candidate, backend):
    monitor = QoSMonitor(
        CellSLO(reliability_shortfall=0.12, min_requests=12, min_gate_samples=25),
        QoSConfig(window_s=3.0, trip_after=2, clear_after=4),
    )
    rollout = RolloutManager(
        candidate, table_factory=lambda b: fleet_gate_table(b, scn, backend=backend),
        canary_cells=(0, 1), promote_after=8, start_at_s=4.0,
    )
    return Orchestrator(monitor=monitor, rollout=rollout), rollout


def test_canary_rollback_and_promotion_e2e(drift_data):
    """The poisoned candidate trips its canaries and rolls back before the
    fleet gap exceeds 1.5x the incumbent's; the good candidate promotes
    and the promoted run equals the incumbent run to round-off."""
    bank = drift_data[2][2]
    scn = small_fleet(drift_data, n_cells=8, requests_per_cell=300)
    incumbent = run_fleet(bank, scn, backend=TORCH_CPU).fleet_summary()
    bad = poisoned_bank(bank)
    assert bad.bank_version == 1
    assert bad.metadata["poisoned"]
    orch, ro = _rollout(scn, bad, TORCH_CPU)
    guarded = run_fleet(bank, scn, orchestrator=orch, backend=TORCH_CPU).fleet_summary()
    assert ro.state == ROLLED_BACK
    assert ro.tripped_canaries and set(ro.tripped_canaries) <= {0, 1}
    assert guarded["miscalibration_gap"] <= 1.5 * incumbent["miscalibration_gap"]
    unguarded = run_fleet(bad, scn, backend=TORCH_CPU).fleet_summary()
    assert unguarded["miscalibration_gap"] > 1.5 * incumbent["miscalibration_gap"]
    orch2, ro2 = _rollout(scn, bank.bumped(), TORCH_CPU)
    promoted = run_fleet(bank, scn, orchestrator=orch2, backend=TORCH_CPU).fleet_summary()
    assert ro2.state == PROMOTED
    for k in ("p99_ms", "miscalibration_gap", "accuracy", "offload_rate"):
        a, b = incumbent[k], promoted[k]
        assert (math.isnan(a) and math.isnan(b)) or a == pytest.approx(b, rel=1e-9, abs=1e-12), k


def test_set_cell_table_validates_compatibility(drift_data):
    from repro_torch.fleet.simulator import FleetConfig, FleetSimulator
    from repro_torch.offload import latency as L

    bank = drift_data[2][2]
    scn = small_fleet(drift_data, n_cells=2, requests_per_cell=50)
    table = fleet_gate_table(bank, scn, backend="numpy")
    sim = FleetSimulator(table, scn.topology, L.paper_2020(), config=FleetConfig(window_s=0.5))
    with pytest.raises(IndexError):
        sim.set_cell_table(5, table)
    val, test = drift_data[:2]
    trunc = {
        "exit_logits": {c: {b: z[:10] for b, z in d.items()}
                        for c, d in test["exit_logits"].items()},
        "final": {c: f[:10] for c, f in test["final"].items()},
        "labels": test["labels"][:10],
        "features": {c: f[:10] for c, f in test["features"].items()},
    }
    other = reference_fleet(n_cells=2, requests_per_cell=50, seed=0, val=val, test=trunc)
    with pytest.raises(ValueError, match="incumbent"):
        sim.set_cell_table(0, fleet_gate_table(bank, other, backend="numpy"))


# ------------------------------------------------------- scenario registry
def test_registry_contents_and_unknown_name():
    assert {"weather_front", "flash_crowd", "link_outage", "cloud_brownout",
            "poisoned_canary", "good_rollout"} <= set(SCENARIOS)
    with pytest.raises(ValueError, match="unknown scenario"):
        run_scenarios(["nope"], device="cpu")


def test_register_scenario_is_open():
    @register_scenario("_tmp_probe")
    def probe(quick=False, seed=0, device=None):
        return {"name": "_tmp_probe", "arms": {}, "wins": {},
                "events": {"quick": quick, "seed": seed, "device": str(device)}, "pass": True}

    try:
        (rec,) = run_scenarios(["_tmp_probe"], quick=True, seed=3, device="cpu")
        assert rec["events"] == {"quick": True, "seed": 3, "device": "cpu"}
        assert rec["pass"] is True
    finally:
        del SCENARIOS["_tmp_probe"]


def test_link_outage_scenario_quick_record():
    """The scenario as a user calls it: the port fits its own plans on the
    named device."""
    (rec,) = run_scenarios(["link_outage"], quick=True, device="cpu")
    assert rec["name"] == "link_outage"
    assert set(rec["arms"]) == {"bank_static", "bank_controller"}
    assert rec["events"]["requests_conserved"]
    assert rec["events"]["shed_requests"] > 0
    assert "p99_ms" in rec["wins"]
    assert json.dumps(rec)
    assert rec["pass"]


@pytest.mark.slow
def test_scenario_matrix_full_scale_all_pass():
    """Every registered adversarial scenario passes its required wins at
    bench scale."""
    records = run_scenarios(device="cpu")
    failed = [r["name"] for r in records if not r["pass"]]
    assert not failed, failed


@pytest.fixture(scope="module")
def quick_records(drift_data):
    """The quick matrix through both packages on the same data and the
    same plans (the reference's fit, carried over as JSON; the
    reference's own fit is deterministic, so caching it changes
    nothing)."""
    val, test, plans, jplans = drift_data
    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(jscen._DATA, 0, (val, test))
        mp.setattr(jscen, "_plans", lambda seed=0: jplans)
        mp.setitem(tscen._DATA, 0, (val, test))
        mp.setattr(tscen, "_plans", lambda seed=0, device=None: plans)
        port = run_scenarios(quick=True, device="cpu")
        ref = jscen.run_scenarios(quick=True)
    finally:
        mp.undo()
    return {r["name"]: r for r in port}, {r["name"]: r for r in ref}


@pytest.mark.parametrize("name", ["weather_front", "flash_crowd", "link_outage",
                                  "cloud_brownout", "poisoned_canary", "good_rollout"])
def test_quick_scenario_matches_reference(quick_records, name):
    """Record by record: the same arms, wins, events and verdict."""
    port, ref = quick_records
    same_value(port[name], ref[name])
    assert port[name]["pass"]


# ------------------------------------------------------- gate shim, drifts
def test_fleet_gate_shim_deprecated_but_identical():
    import repro_torch.fleet.gate as shim
    from repro_torch.core.gatepath import GateTable, get_gate_backend

    with pytest.warns(DeprecationWarning, match="repro_torch.core.gatepath"):
        assert shim.FleetGateTable is GateTable
    with pytest.warns(DeprecationWarning):
        assert shim.get_gate_backend is get_gate_backend
    with pytest.warns(DeprecationWarning, match="TorchGateBackend"):
        assert shim.JaxGateBackend is TorchGateBackend
    with pytest.raises(AttributeError):
        shim.definitely_not_here
    assert "FleetGateTable" in dir(shim)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        from repro_torch.fleet import FleetGateTable

        assert FleetGateTable is GateTable


def test_single_state_markov_schedule():
    sch = MarkovContextSchedule(["clean"], dwell_s=0.5, seed=0)
    t = np.linspace(0.0, 20.0, 101)
    assert np.all(sch.context_ids_at(t) == 0)
    assert sch.context_at(13.7) == "clean"


def test_diurnal_amplitude_one_trough_hits_zero():
    env = DiurnalEnvelope(period_s=10.0, amplitude=1.0)
    t = np.linspace(0.0, 10.0, 1001)
    assert float(env.rate_factor(t).min()) == pytest.approx(0.0, abs=1e-9)
    wl = poisson_cell_workload(20.0, 500, 64, seed=2, envelope=env)
    assert len(wl) == 500
    assert np.all(np.diff(wl.arrival_s) >= 0)
    assert float(env.rate_factor(wl.arrival_s).min()) > 0.0


def test_empty_arrival_windows_through_orchestrated_path(drift_data):
    """One cell's stream ends long before the other's: no spurious trips
    on its empty windows, and the orchestrated run still balances."""
    bank = drift_data[2][2]
    scn = small_fleet(drift_data, n_cells=2, requests_per_cell=200)
    short = poisson_cell_workload(200.0, 40, 512, seed=9)
    cells = list(scn.topology.cells)
    cells[0] = CellConfig(network=cells[0].network, workload=short,
                          n_devices=cells[0].n_devices, schedule=cells[0].schedule,
                          deadline_s=cells[0].deadline_s)
    scn.topology = FleetTopology(cells, cloud_servers=2)
    monitor = QoSMonitor(CellSLO(p99_ms=1e4, min_requests=5),
                         QoSConfig(window_s=1.0, trip_after=1))
    tel = run_fleet(bank, scn, orchestrator=Orchestrator(monitor=monitor), backend=TORCH_CPU)
    assert tel.requests() == 40 + 200
    assert not monitor.trip_log


# ------------------------------------------------------- bank round-trips
def test_bank_json_roundtrip_with_versions(drift_data):
    bank = drift_data[2][2]
    b3 = bank.bumped(3)
    d = b3.to_dict()
    assert d["schema_version"] == 1
    assert d["version"] == 1
    assert d["bank_version"] == 3
    back = PlanBank.from_json(b3.to_json())
    assert back.bank_version == 3
    assert back.to_json() == b3.to_json()
    assert back.to_json() == drift_data[3][2].bumped(3).to_json()  # the reference's text
    legacy = bank.to_dict()
    del legacy["schema_version"]
    del legacy["bank_version"]
    old = PlanBank.from_dict(legacy)
    assert old.bank_version == 0
    assert old.contexts == bank.contexts
    z = np.random.default_rng(0).normal(size=(16, 10))
    for ctx in bank.contexts:
        a, _ = bank.plan_for(ctx).gate_block(z, branch=0, backend="numpy")
        b, _ = old.plan_for(ctx).gate_block(z, branch=0, backend="numpy")
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="newer"):
        PlanBank.from_dict({**bank.to_dict(), "schema_version": 99})


def test_poisoned_bank_validation(drift_data):
    bank = drift_data[2][2]
    with pytest.raises(ValueError, match="temp_scale"):
        poisoned_bank(bank, temp_scale=0.0)
    bad = poisoned_bank(bank)
    jbad = jscen.poisoned_bank(drift_data[3][2])
    assert bad.to_json() == jbad.to_json()
    for ctx in bank.contexts:
        good_t = bank.plan_for(ctx).temperatures
        bad_t = bad.plan_for(ctx).temperatures
        assert all(b == pytest.approx(0.05 * g) for g, b in zip(good_t, bad_t))


# ------------------------------------------------ against the reference
def test_orchestrated_run_matches_reference(drift_data):
    """Churn, a QoS monitor watching every SLO (calibration ones too) and
    the fleet controller taking its distress signal: both packages trip,
    clear, shed and switch alike, and the live QoS estimates agree."""
    val, test, (_, _, bank), (_, _, jbank) = drift_data
    scn = small_fleet(drift_data, n_cells=8, requests_per_cell=300)
    jscn_ = small_fleet(drift_data, n_cells=8, requests_per_cell=300, ref=True)
    slo = dict(p99_ms=60.0, deadline_miss_rate=0.2, reliability_shortfall=0.1,
               ece_cap=0.08, coverage_floor=0.9, min_requests=10, min_gate_samples=15)
    qcfg = dict(window_s=2.0, trip_after=2, clear_after=2)
    mon = QoSMonitor(CellSLO(**slo), QoSConfig(**qcfg))
    jmon = JQoSMonitor(JSLO(**slo), JQoSConfig(**qcfg))
    churn = ChurnSchedule.outage([2, 5], start_s=3.0, duration_s=5.0)
    jchurn = JChurn.outage([2, 5], start_s=3.0, duration_s=5.0)
    tel = run_fleet(bank, scn, with_controller=True, backend=TORCH_CPU,
                    orchestrator=Orchestrator(churn=churn, monitor=mon))
    jtel = jrun_fleet(jbank, jscn_, with_controller=True,
                      orchestrator=JOrchestrator(churn=jchurn, monitor=jmon))
    assert mon.trip_log and mon.trip_log == jmon.trip_log
    assert mon.clear_log == jmon.clear_log
    assert tel.orchestration_events == jtel.orchestration_events
    assert tel.controller_events == jtel.controller_events
    same_value(tel.fleet_summary(), jtel.fleet_summary())
    for c in range(8):
        for now in (4.0, 9.0, 14.0):
            same_value(tel.cell_qos_estimate(c, 3.0, now), jtel.cell_qos_estimate(c, 3.0, now))
