"""Port parity for the compiled fleet pipeline (`repro_torch.fleet.compiled`)
on the CPU, through `CompiledGateBackend(device="cpu")`.

The data are the drift scenario of tests/test_fleet_compiled.py (blur
underconfident), from both packages' generators, with the reference's
plans carried over as JSON (tests/test_torch_fleet.py does the same).
Every case is held against two runs of the same scenario:

* the port's host `FleetSimulator` on the same gate table (the
  ``"compiled"`` backend is ``"torch"`` under another name);
* the reference's host simulator, `repro.fleet.scenarios.run_fleet(...,
  backend="numpy")`, the spec the reference's own compiled tests use.

Tolerances:
* integer and boolean per-request columns, decision-derived summary
  numbers, orchestration events, audit records and counters: equal;
* latencies (per request, the summaries' ``*_ms``, trace span edges):
  rtol 1e-9 / atol 1e-12 (LAT_TOL, tests/test_fleet_compiled.py): the
  compiled chains run as whole lanes, the host's per window;
* gate confidences against the reference: rel 2e-5 / abs 1e-6 (hazard
  h); against the port's host run: equal (same table);
* the reliability sketch against the port's host run: count rows equal,
  confidence sums rel 1e-12 (the program adds them in another order);
* decisions away from p_tar +- 1e-6 (hazard d): the data hold no
  confidence there (tests/test_torch_fleet.py checks it).
"""
import math

import numpy as np
import pytest
import torch

import repro.fleet.topology as jtopo
import repro.serving.drift as jdrift
import repro.serving.network as jnet
from repro.fleet.scenarios import reference_fleet as jreference_fleet
from repro.fleet.scenarios import run_fleet as jrun_fleet
from repro.fleet.simulator import FleetConfig as JFleetConfig
from repro.fleet.simulator import FleetSimulator as JFleetSimulator
from repro.fleet.scenarios import fleet_gate_table as jfleet_gate_table
from repro.obs import full_observability as jfull
from repro.orchestration import ChurnSchedule as JChurn
from repro.orchestration import Orchestrator as JOrchestrator
from repro.orchestration.qos import CellSLO as JSLO
from repro.orchestration.qos import QoSConfig as JQoSConfig
from repro.orchestration.qos import QoSMonitor as JQoSMonitor
from repro.serving import scenarios as jscn
import repro_torch.fleet.topology as ttopo
import repro_torch.serving.drift as tdrift
import repro_torch.serving.network as tnet
from repro_torch.core.bank import PlanBank
from repro_torch.core.gatepath import TorchGateBackend, get_gate_backend
from repro_torch.core.policy import OffloadPlan
from repro_torch.fleet import (
    CompiledFleetSimulator,
    CompiledGateBackend,
    FleetConfig,
    FleetSimulator,
)
from repro_torch.fleet import compiled
from repro_torch.fleet.scenarios import fleet_gate_table, reference_fleet, run_fleet
from repro_torch.fleet.telemetry import _CellColumns
from repro_torch.obs import full_observability
from repro_torch.obs.check import run_checks
from repro_torch.offload import latency as L
from repro_torch.orchestration import ChurnSchedule, Orchestrator, RolloutManager
from repro_torch.orchestration.qos import CellSLO, QoSConfig, QoSMonitor
from repro_torch.serving import scenarios as tscn

COMPILED_CPU = CompiledGateBackend(device="cpu")
TORCH_CPU = TorchGateBackend(device="cpu")
LAT_TOL = dict(rtol=1e-9, atol=1e-12)
CONF_TOL = dict(rel=2e-5, abs=1e-6)
SKETCH_COUNT_ROWS = (0, 1, 5, 6)  # n, correct, on, on & correct
SKETCH_CONF_ROWS = (2, 3, 4)  # sum conf, sum conf^2, sum conf * correct


@pytest.fixture(scope="module")
def drift_data():
    """The fleet bench's data from both packages' generators (checked
    equal) and the reference's plans, carried over as JSON."""
    val, test = tscn.synthetic_distorted_cascade(directions={"gaussian_blur": "under"})
    jval, jtest = jscn.synthetic_distorted_cascade(directions={"gaussian_blur": "under"})
    np.testing.assert_array_equal(test["labels"], jtest["labels"])
    for ctx in test["final"]:
        np.testing.assert_array_equal(test["final"][ctx], jtest["final"][ctx])
        for b in (1, 2):
            np.testing.assert_array_equal(test["exit_logits"][ctx][b],
                                          jtest["exit_logits"][ctx][b])
    jplans = jscn.fit_drift_plans(jval)
    plans = tuple((PlanBank if i == 2 else OffloadPlan).from_json(p.to_json())
                  for i, p in enumerate(jplans))
    return val, test, plans, jplans


def fleets(drift_data, n_cells=6, requests_per_cell=200):
    """(port scenario, reference scenario): the same topology."""
    val, test = drift_data[:2]
    kw = dict(n_cells=n_cells, requests_per_cell=requests_per_cell, seed=0, val=val,
              test=test, cloud_servers=2)
    return reference_fleet(**kw), jreference_fleet(**kw)


def same_fleet(tel, other):
    """Per-request columns (latencies to LAT_TOL, the rest equal), the
    fleet and per-cell summaries (``*_ms`` to LAT_TOL, the rest equal)
    and the orchestration events."""
    assert tel.n_cells == other.n_cells
    for c in range(tel.n_cells):
        for f in _CellColumns.FIELDS:
            a, b = tel._cells[c].column(f), other._cells[c].column(f)
            if f == "latency_s":
                np.testing.assert_allclose(a, b, **LAT_TOL, err_msg=f"cell {c}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"cell {c} {f}")
    pairs = [(tel.fleet_summary(), other.fleet_summary())] + list(
        zip(tel.per_cell_summary(), other.per_cell_summary()))
    for a, b in pairs:
        assert a.keys() == b.keys()
        for k in a:
            if k.endswith("_ms"):
                np.testing.assert_allclose(a[k], b[k], **LAT_TOL, err_msg=k)
            else:
                assert a[k] == b[k] or (a[k] != a[k] and b[k] != b[k]), (k, a[k], b[k])
    assert tel.orchestration_events == other.orchestration_events
    assert tel.controller_events == other.controller_events == []


def churn_shed(pkg):
    churn = (ChurnSchedule, Orchestrator) if pkg == "port" else (JChurn, JOrchestrator)
    return churn[1](churn=churn[0].outage([0, 2], start_s=2.0, duration_s=2.0))


def backhaul(pkg):
    churn = (ChurnSchedule, Orchestrator) if pkg == "port" else (JChurn, JOrchestrator)
    return churn[1](churn=churn[0].outage(list(range(6)), start_s=1.0, duration_s=2.0))


def qos_monitor(pkg):
    slo, cfg, mon, orch = ((CellSLO, QoSConfig, QoSMonitor, Orchestrator) if pkg == "port"
                           else (JSLO, JQoSConfig, JQoSMonitor, JOrchestrator))
    return orch(monitor=mon(slo(p99_ms=1e-3, min_requests=1),
                            cfg(window_s=2.0, trip_after=1, clear_after=1000)))


#: tests/test_fleet_compiled.py:67-131: plan index, orchestrator factory
ARMS = {
    "bank": (2, None),
    "plain_plan": (1, None),
    "churn_shed": (2, churn_shed),
    "backhaul": (2, backhaul),
    "qos_monitor": (2, qos_monitor),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_compiled_matches_host_and_reference(drift_data, arm):
    """The compiled run equals the port's host simulator on the same table
    and the reference's host simulator, request by request."""
    _, _, plans, jplans = drift_data
    i, orch = ARMS[arm]
    scn, jscn_ = fleets(drift_data)
    make = orch or (lambda pkg: None)
    table = fleet_gate_table(plans[i], scn, backend=COMPILED_CPU)
    profile, cfg = L.paper_2020(), FleetConfig(window_s=0.5)
    hsim = FleetSimulator(table, scn.topology, profile, config=cfg, orchestrator=make("port"))
    host = hsim.run()
    sim = CompiledFleetSimulator(table, scn.topology, profile, config=cfg,
                                 orchestrator=make("port"))
    tel = sim.run()
    ref = jrun_fleet(jplans[i], jscn_, backend="numpy", orchestrator=make("ref"))
    same_fleet(tel, host)
    same_fleet(tel, ref)
    s = tel.fleet_summary()
    assert s["requests"] == scn.topology.n_requests and 0.0 < s["offload_rate"] < 1.0
    assert set(sim.host_s) == {"prepass", "program", "recovery"} and sim.stage_ms == {}
    kinds = [k for _, k, _ in tel.orchestration_events]
    if arm == "qos_monitor":
        assert "qos_trip" in kinds  # the SLO is designed to trip
    if arm in ("churn_shed", "backhaul"):
        assert sim.shed_counts.sum() > 0
        np.testing.assert_array_equal(sim.shed_counts, hsim.shed_counts)


def traced_topologies(drift_data):
    """Three cells off the reference fleet's path: a looping trace link
    with a piecewise schedule, a Markov link with a short-dwell Markov
    schedule, a fixed link with a piecewise schedule -- through both
    packages' classes."""
    test = drift_data[1]
    n = len(test["labels"])

    def build(topo, drift, net):
        cells = [
            topo.CellConfig(
                network=net.TraceNetwork([0.0, 0.7, 1.9], [4e6, 18.8e6, 2e6], period_s=3.1),
                workload=topo.poisson_cell_workload(20.0, 160, n, n_devices=2, seed=5),
                n_devices=2, deadline_s=0.1,
                schedule=drift.PiecewiseSchedule([(0.0, "clean"), (2.5, "contrast@4"),
                                                  (6.0, "gaussian_noise@2")])),
            topo.CellConfig(
                network=net.MarkovNetwork(good_bps=18.8e6, bad_bps=1.5e6, p_good_to_bad=0.5,
                                          p_bad_to_good=0.2, dwell_s=0.3, seed=9),
                workload=topo.poisson_cell_workload(25.0, 160, n, n_devices=3, seed=6),
                n_devices=3, deadline_s=0.1,
                schedule=drift.MarkovContextSchedule(
                    ["clean", "gaussian_blur@3", "contrast@4"], dwell_s=0.1, p_stay=0.5,
                    seed=3)),
            topo.CellConfig(
                network=net.FixedRateNetwork(8e6),
                workload=topo.poisson_cell_workload(15.0, 160, n, n_devices=1, seed=7),
                schedule=drift.PiecewiseSchedule([(0.0, "gaussian_blur@3"), (4.0, "clean")]),
                deadline_s=None),
        ]
        return topo.FleetTopology(cells, cloud_servers=2)

    return build(ttopo, tdrift, tnet), build(jtopo, jdrift, jnet)


def test_compiled_trace_links_piecewise_schedules_and_brownout(drift_data):
    """Trace links (knot lookups modulo the period), piecewise schedules,
    a short-dwell Markov link, device counts 1-3 and a cloud brownout:
    the program's lookups and the host's agree request by request."""
    _, test, plans, jplans = drift_data
    topo, jtopo_ = traced_topologies(drift_data)
    slow = ((2.0, 4.5, 3.0), (3.0, 3.5, 1.7))
    cfg, jcfg = FleetConfig(0.5, slow), JFleetConfig(0.5, slow)
    profile = L.paper_2020()
    table = fleet_gate_table(plans[2], reference_fleet(1, 1, val=test, test=test),
                             backend=COMPILED_CPU)
    jtable = jfleet_gate_table(jplans[2], jreference_fleet(1, 1, val=test, test=test))
    tel = CompiledFleetSimulator(table, topo, profile, config=cfg).run()
    same_fleet(tel, FleetSimulator(table, topo, profile, config=cfg).run())
    same_fleet(tel, JFleetSimulator(jtable, jtopo_, profile, config=jcfg).run())
    assert set(tel.per_context_summary()) >= {"clean", "contrast@4", "gaussian_blur@3"}


def test_compiled_lookups_match_numpy_floor_division(drift_data):
    """`_ctx_at` / `_rate_at` at t = k * dwell (and k * period, the trace
    knots shifted by whole periods) and at the floats on either side equal
    the host lookups: numpy's `//` and `np.mod`, not floor(t / d)."""
    _, test, plans, _ = drift_data
    topo, _ = traced_topologies(drift_data)
    table = fleet_gate_table(plans[2], reference_fleet(1, 1, val=test, test=test),
                             backend=COMPILED_CPU)
    sim = CompiledFleetSimulator(table, topo, L.paper_2020())
    host = {k: torch.as_tensor(v) if not isinstance(v, bool) else v
            for k, v in {**sim._net_tables(700.0), **sim._ctx_tables(700.0)}.items()}
    k = np.arange(0, 200, dtype=np.float64)
    grid = [k * 0.1, k * 0.3, k * 3.1, np.add.outer(np.arange(15) * 3.1,
                                                    [0.0, 0.7, 1.9]).ravel(),
            np.array([2.5, 4.0, 6.0])]
    base = np.concatenate(grid)
    t = np.concatenate([base, np.nextafter(base, np.inf), np.nextafter(base, -np.inf), [-1.0]])
    # the case the rule is for: floor(t / d) and numpy's t // d disagree here
    assert np.any(np.floor(t / 0.1) != t // 0.1)
    tt = torch.as_tensor(t)
    for c, cell in enumerate(topo.cells):
        cells = torch.full_like(tt, c, dtype=torch.int64)
        got_rate = compiled._rate_at(host, cells, tt).numpy()
        np.testing.assert_array_equal(got_rate, cell.network.rates_bps(t), err_msg=f"cell {c}")
        got_ctx = compiled._ctx_at(host, cells, tt).numpy()
        np.testing.assert_array_equal(got_ctx, sim._ctx_ids(c, t), err_msg=f"cell {c}")


def test_compiled_level2_codec_arm(drift_data):
    """tests/test_compress.py's level-2 arm: host and compiled agree per
    request on a compressed static deployment (scaled wire bytes,
    per-level cloud predictions, energy), and the compressed run differs
    from the raw one."""
    _, _, plans, jplans = drift_data
    scn, jscn_ = fleets(drift_data, n_cells=4, requests_per_cell=120)
    plan = plans[1].with_compression(2)
    tel = run_fleet(plan, scn, backend=COMPILED_CPU)
    same_fleet(tel, run_fleet(plan, scn, backend=TORCH_CPU))
    same_fleet(tel, jrun_fleet(jplans[1].with_compression(2), jscn_, backend="numpy"))
    raw = run_fleet(plans[1], scn, backend=COMPILED_CPU).fleet_summary()
    assert raw["energy_j_total"] > tel.fleet_summary()["energy_j_total"]


def test_compiled_gate_backend_parity(drift_data):
    """tests/test_gatepath.py's simulator-level case with "compiled": a
    ~2k-request fleet over the numpy, torch and compiled backends gives
    the same telemetry, and run_fleet routes "compiled" to the compiled
    simulator."""
    _, _, plans, _ = drift_data
    scn = reference_fleet(n_cells=4, requests_per_cell=500, val=drift_data[0],
                          test=drift_data[1])
    a = run_fleet(plans[2], scn, backend="numpy")
    ran = []
    run = CompiledFleetSimulator.run

    def spy(self):
        ran.append(type(self))
        return run(self)

    CompiledFleetSimulator.run = spy
    try:
        b = run_fleet(plans[2], scn, backend=COMPILED_CPU)
    finally:
        CompiledFleetSimulator.run = run
    assert ran == [CompiledFleetSimulator]
    same_fleet(b, a)
    same_fleet(b, run_fleet(plans[2], scn, backend=TORCH_CPU))
    assert a.fleet_summary()["requests"] == 2000


# ------------------------------------------------------------- scope limits
def test_compiled_rejects_controller(drift_data):
    _, _, plans, _ = drift_data
    scn, _ = fleets(drift_data)
    with pytest.raises(ValueError, match="host backend"):
        run_fleet(plans[2], scn, with_controller=True, backend=COMPILED_CPU)
    table = fleet_gate_table(plans[2], scn, backend=COMPILED_CPU)
    with pytest.raises(ValueError, match="host backend"):
        CompiledFleetSimulator(table, scn.topology, L.paper_2020(), controller=object())


def test_compiled_rejects_rollout(drift_data):
    _, _, plans, _ = drift_data
    scn, _ = fleets(drift_data)
    bank = plans[2]
    ro = RolloutManager(bank.bumped(), lambda b: b, canary_cells=(0,))
    orch = Orchestrator(monitor=QoSMonitor(CellSLO(p99_ms=1e3)), rollout=ro)
    with pytest.raises(ValueError, match="does not support canary rollouts"):
        run_fleet(bank, scn, orchestrator=orch, backend=COMPILED_CPU)


def test_compiled_rejects_a_mesh(drift_data):
    """The mesh keyword takes None, "auto" (one device without a process
    group) or a "cells" MeshSpec; it rejects any other object, a mesh
    that does not divide the cells ("shard evenly", the reference's
    message) and a described mesh of several devices, which has no
    ranks. tests/test_torch_ranks_fleet.py runs real meshes."""
    from repro_torch.launch.mesh import MeshSpec, make_debug_mesh
    from repro_torch.sharding import fleet_mesh

    _, _, plans, _ = drift_data
    scn, _ = fleets(drift_data, n_cells=2, requests_per_cell=40)
    table = fleet_gate_table(plans[1], scn, backend=COMPILED_CPU)

    class FakeMesh:
        size = 4

    for bad in (FakeMesh(), make_debug_mesh(2, 1)):
        with pytest.raises(ValueError, match="takes mesh=None, 'auto' or a 'cells' mesh"):
            CompiledFleetSimulator(table, scn.topology, L.paper_2020(), mesh=bad)
    with pytest.raises(ValueError, match="shard evenly"):
        CompiledFleetSimulator(table, scn.topology, L.paper_2020(),
                               mesh=MeshSpec(("cells",), (4,)))
    with pytest.raises(ValueError, match="has no ranks"):
        CompiledFleetSimulator(table, scn.topology, L.paper_2020(),
                               mesh=MeshSpec(("cells",), (2,)))
    with pytest.raises(ValueError, match="asked for 2 mesh devices, have 1"):
        fleet_mesh(2)
    c = CompiledFleetSimulator(table, scn.topology, L.paper_2020(), mesh=fleet_mesh())
    assert c.mesh == MeshSpec(("cells",), (1,))
    same_fleet(c.run(), run_fleet(plans[1], scn, backend=TORCH_CPU))
    a = CompiledFleetSimulator(table, scn.topology, L.paper_2020(), mesh=None).run()
    b = CompiledFleetSimulator(table, scn.topology, L.paper_2020(), mesh="auto").run()
    same_fleet(a, b)
    assert get_gate_backend("compiled").name == "compiled"


# ------------------------------------------- observability (tests/test_obs.py)
def same_records(recs, other, conf_close):
    """Same sampled records: non-float fields equal, floats to LAT_TOL, the
    gate confidence to CONF_TOL where `conf_close`, else equal."""
    assert len(recs) == len(other) > 0

    def check(a, b, path):
        if isinstance(a, dict):
            assert isinstance(b, dict) and a.keys() == b.keys(), path
            for k in a:
                check(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                check(x, y, f"{path}[{i}]")
        elif isinstance(a, float) and not isinstance(a, bool):
            if path.endswith(".confidence") and conf_close:
                assert a == pytest.approx(b, **CONF_TOL), path
            else:
                assert a == pytest.approx(b, rel=1e-9, abs=1e-12), path
        else:
            assert a == b, path

    for a, b in zip(recs, other):
        check(a, b, f"req {a['req_id']}")


def same_sketch(obs, other, conf_tol):
    """Reliability sketches: the same keys, count rows equal, confidence
    sums to `conf_tol`."""
    a, b = obs.calibration._blocks, other.calibration._blocks
    assert set(a) == set(b) and a
    for key in a:
        np.testing.assert_array_equal(a[key][list(SKETCH_COUNT_ROWS)],
                                      b[key][list(SKETCH_COUNT_ROWS)], err_msg=str(key))
        np.testing.assert_allclose(a[key][list(SKETCH_CONF_ROWS)],
                                   b[key][list(SKETCH_CONF_ROWS)], **conf_tol,
                                   err_msg=str(key))
    assert obs.calibration._ungated == other.calibration._ungated


OBS_CASES = {  # tests/test_obs.py:346-395: (trace_sample_every, churn cells, start, duration)
    "sampled": (7, None),
    "churn": (1, ([0, 2], 2.0, 4.0)),
    "backhaul": (1, (list(range(6)), 2.0, 3.0)),
}


@pytest.mark.parametrize("case", list(OBS_CASES))
def test_compiled_observability_matches_host_and_reference(drift_data, case):
    """With every sink on, the compiled run's sampled trace passes the
    `obs.check` invariants and matches the host runs record for record;
    counters, shed audit and the reliability sketch agree."""
    _, _, plans, jplans = drift_data
    every, churn = OBS_CASES[case]
    scn, jscn_ = fleets(drift_data)

    def orch(pkg):
        if churn is None:
            return None
        sched, o = (ChurnSchedule, Orchestrator) if pkg == "port" else (JChurn, JOrchestrator)
        return o(churn=sched.outage(churn[0], start_s=churn[1], duration_s=churn[2]))

    runs = {}
    for name, backend in (("compiled", COMPILED_CPU), ("host", TORCH_CPU)):
        obs = full_observability(trace_sample_every=every)
        tel = run_fleet(plans[2], scn, backend=backend, orchestrator=orch("port"), obs=obs)
        runs[name] = (tel, obs)
    jobs = jfull(trace_sample_every=every)
    jtel = jrun_fleet(jplans[2], jscn_, backend="numpy", orchestrator=orch("ref"), obs=jobs)
    (tel, obs), (htel, hobs) = runs["compiled"], runs["host"]
    assert run_checks(obs.trace.records, obs.metrics, obs.audit.records) == []
    same_fleet(tel, htel)
    same_fleet(tel, jtel)
    assert len(obs.trace.records) == math.ceil(scn.topology.n_requests / every)
    same_records(obs.trace.records, hobs.trace.records, conf_close=False)
    same_records(obs.trace.records, jobs.trace.records, conf_close=True)
    for other in (hobs, jobs):
        for name in ("fleet_requests_total", "fleet_offloaded_total", "fleet_shed_total",
                     "fleet_uplink_bytes_total"):
            assert obs.metrics.counter_total(name) == other.metrics.counter_total(name), name
        assert (obs.metrics.gauge_value("fleet_requests_completed")
                == other.metrics.gauge_value("fleet_requests_completed"))
        assert ([s["evidence"] for s in obs.audit.filter(action="shed_route")]
                == [s["evidence"] for s in other.audit.filter(action="shed_route")])
    same_sketch(obs, hobs, dict(rtol=1e-12, atol=0))
    same_sketch(obs, jobs, dict(rtol=2e-5, atol=1e-6))
    if case == "backhaul":
        backhauled = [r for r in obs.trace.records if r["gate"] is None]
        assert backhauled and all(not r["on_device"] for r in backhauled)
    if churn is not None:
        assert obs.audit.filter(action="shed_route")
