"""Port parity for the fleet simulator (`repro_torch.fleet`: topology,
telemetry, simulator, controller, scenarios) against `repro.fleet` on
the CPU: every non-slow case of tests/test_fleet.py run on the port, the
numpy-against-torch case of tests/test_gatepath.py, the fleet cases of
tests/test_obs.py, and the same fleets run through both packages.

The plans are the reference's fit, carried over as JSON (the two
packages' temperature fits differ within ROADMAP hazard c, which would
move decisions); one case lets the port fit its own.

Tolerances:
* decision-derived numbers (requests, offload rate, accuracy, the
  miscalibration gap, deadline misses, switches, energy) and the integer
  and boolean per-request columns: equal;
* latencies (per request, and the summaries' mean/p50/p95/p99): rel 1e-9;
* gate confidences (trace records, calibration gauges): rel 2e-5 /
  abs 1e-6, the gate tolerance (hazard h);
* decisions are compared only away from p_tar +- 1e-6 (K1's boundary,
  hazard d): the data are checked to hold no confidence there.
"""
import copy
import json
import math

import numpy as np
import pytest

from repro.core.policy import OffloadPlan as JPlan
from repro.fleet import FleetConfig as JFleetConfig
from repro.fleet import FleetControllerConfig as JFCC
from repro.fleet import FleetGateTable as JGateTable
from repro.fleet import FleetSimulator as JFleetSimulator
from repro.fleet.scenarios import reference_fleet as jreference_fleet
from repro.fleet.scenarios import run_fleet as jrun_fleet
from repro.fleet.simulator import fifo_done as jfifo_done
from repro.fleet.topology import poisson_cell_workload as jpoisson_cell_workload
from repro.fleet.topology import DiurnalEnvelope as JEnvelope
from repro.obs import full_observability as jfull
from repro.orchestration import ChurnSchedule as JChurn
from repro.orchestration import Orchestrator as JOrchestrator
from repro.serving import scenarios as jscn
from repro_torch.core.bank import PlanBank
from repro_torch.core.calibration import TemperatureScaling
from repro_torch.core.gatepath import TorchGateBackend
from repro_torch.core.policy import OffloadPlan, rescore_plan
from repro_torch.fleet import (
    CellConfig,
    FleetConfig,
    FleetController,
    FleetControllerConfig,
    FleetGateTable,
    FleetSimulator,
    FleetTopology,
)
from repro_torch.fleet.scenarios import reference_fleet, run_fleet
from repro_torch.fleet.simulator import fifo_done
from repro_torch.fleet.telemetry import _CellColumns
from repro_torch.fleet.topology import CellWorkload, DiurnalEnvelope, poisson_cell_workload
from repro_torch.obs import full_observability
from repro_torch.obs.check import run_checks
from repro_torch.offload import latency as L
from repro_torch.orchestration import ChurnSchedule, Orchestrator
from repro_torch.serving import (
    FixedRateNetwork,
    LogitsCore,
    MarkovNetwork,
    RuntimeConfig,
    ServingRuntime,
    TraceNetwork,
    constant_workload,
    poisson_workload,
)
from repro_torch.serving import scenarios as tscn
from repro_torch.serving.drift import ContextualLogitsCore, MarkovContextSchedule

TORCH_CPU = TorchGateBackend(device="cpu")
BOUNDARY = 1e-6  # K1's boundary band around p_tar (hazard d)
#: every p_tar a fleet run visits: the plans' and the controller grid's
P_TARS = (0.3, 0.5, 0.7, 0.8)
LATENCY_KEYS = ("mean_ms", "p50_ms", "p95_ms", "p99_ms")
CONF_TOL = dict(rel=2e-5, abs=1e-6)
CONF_FAMILIES = ("calibration_ece", "calibration_brier", "calibration_confidence_sum")


def near_boundary(conf, p_tars=P_TARS) -> int:
    """How many confidences sit within BOUNDARY of any of `p_tars`."""
    c = np.asarray(conf, np.float64).ravel()
    return int(sum((np.abs(c - p) <= BOUNDARY).sum() for p in p_tars))


def same_number(a, b, rel=0.0):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b or (rel > 0 and abs(a - b) <= rel * max(abs(a), abs(b)))


def same_summary(a, b, what=""):
    """Equal summaries; latencies to rel 1e-9, nan matching nan."""
    assert a.keys() == b.keys(), what
    for k in a:
        rel = 1e-9 if k in LATENCY_KEYS else 0.0
        assert same_number(a[k], b[k], rel), f"{what} {k}: {a[k]!r} against {b[k]!r}"


def same_columns(tel, jtel):
    """Every cell's per-request columns: latencies to rel 1e-9, the rest
    equal."""
    assert tel.n_cells == jtel.n_cells
    for c in range(tel.n_cells):
        for f in _CellColumns.FIELDS:
            a, b = tel._cells[c].column(f), jtel._cells[c].column(f)
            if f == "latency_s":
                np.testing.assert_allclose(a, b, rtol=1e-9, atol=0, err_msg=f"cell {c}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"cell {c} {f}")


def same_fleet(tel, jtel):
    same_columns(tel, jtel)
    same_summary(tel.fleet_summary(), jtel.fleet_summary(), "fleet")
    for c, (a, b) in enumerate(zip(tel.per_cell_summary(), jtel.per_cell_summary())):
        same_summary(a, b, f"cell {c}")
    pa, pb = tel.per_context_summary(), jtel.per_context_summary()
    assert pa.keys() == pb.keys()
    for k in pa:
        same_summary(pa[k], pb[k], k)
    assert tel.controller_events == jtel.controller_events
    assert tel.orchestration_events == jtel.orchestration_events


def as_cell_workload(requests):
    """The same Request stream the event runtime serves, as columns."""
    return CellWorkload(
        np.asarray([r.arrival_s for r in requests]),
        np.asarray([r.sample for r in requests]),
        np.asarray([r.device for r in requests]),
    )


@pytest.fixture(scope="module")
def cascade():
    exits, final, y = tscn.synthetic_cascade_logits(512)
    plan = OffloadPlan(p_tar=0.8, calibrators=[TemperatureScaling.from_temperature(1.0)] * 2)
    return exits, final, y, plan, L.paper_2020()


@pytest.fixture(scope="module")
def drift_data():
    """The fleet bench's data (blur underconfident) from both packages'
    generators, and the reference's plans carried over as JSON."""
    val, test = tscn.synthetic_distorted_cascade(directions={"gaussian_blur": "under"})
    jval, jtest = jscn.synthetic_distorted_cascade(directions={"gaussian_blur": "under"})
    for split, jsplit in ((val, jval), (test, jtest)):
        np.testing.assert_array_equal(split["labels"], jsplit["labels"])
        for ctx in split["exit_logits"]:
            np.testing.assert_array_equal(split["features"][ctx], jsplit["features"][ctx])
            np.testing.assert_array_equal(split["final"][ctx], jsplit["final"][ctx])
            for b in (1, 2):
                np.testing.assert_array_equal(split["exit_logits"][ctx][b],
                                              jsplit["exit_logits"][ctx][b])
    jplans = jscn.fit_drift_plans(jval)
    plans = tuple((PlanBank if i == 2 else OffloadPlan).from_json(p.to_json())
                  for i, p in enumerate(jplans))
    return val, test, plans, jplans


def small_fleet(drift_data, seed=0, n_cells=6, requests_per_cell=200, ref=False):
    val, test = drift_data[:2]
    make = jreference_fleet if ref else reference_fleet
    return make(n_cells=n_cells, requests_per_cell=requests_per_cell, seed=seed,
                val=val, test=test, cloud_servers=2)


def test_fleet_data_keep_clear_of_the_boundary(drift_data):
    """No gate confidence of the test tables or of the controller's
    validation blocks lies within 1e-6 of a p_tar the runs visit."""
    val, test, plans, _ = drift_data
    for p in plans:
        table = FleetGateTable(test["exit_logits"], test["final"], p, labels=test["labels"],
                               features_by_context=test["features"], backend="numpy")
        assert near_boundary(table.conf) == 0
        ctrl = FleetController(p, L.paper_2020(), val["exit_logits"], n_cells=1,
                               final_logits=val["final"], labels=val["labels"],
                               backend="numpy")
        assert near_boundary(np.concatenate([c for c, _ in ctrl.core._exit_stats])) == 0


# ------------------------------------------------------- FIFO recurrence
def test_fifo_done_matches_sequential():
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 10, 200))
    s = rng.uniform(0.01, 0.3, 200)
    done = fifo_done(t, s, free_s=2.0)
    prev = 2.0
    for i in range(200):
        prev = max(t[i], prev) + s[i]
        assert done[i] == pytest.approx(prev, rel=1e-12)
    np.testing.assert_array_equal(done, jfifo_done(t, s, free_s=2.0))


# -------------------------------------------------- single-cell equality
@pytest.mark.parametrize("congested", [False, True], ids=["empty", "queued"])
def test_fleet_matches_event_runtime_single_cell(cascade, congested):
    """One cell, one device, fixed link, per-sample transfers: the
    vectorized pipeline IS the event simulator, request for request; and
    the port's fleet run equals the reference's."""
    exits, final, y, plan, profile = cascade
    n = len(y)
    if congested:
        reqs = poisson_workload(120.0, 800, n, deadline_s=0.1, seed=4)
    else:
        reqs = constant_workload(10.0, n, n, deadline_s=0.1)
    rt = ServingRuntime(
        LogitsCore(exits, final, plan, labels=y, device="cpu"), profile, plan, reqs,
        network=FixedRateNetwork(profile.uplink_bps),
        config=RuntimeConfig(max_batch=1),
    )
    tel = rt.run()

    topo = FleetTopology([
        CellConfig(network=FixedRateNetwork(profile.uplink_bps),
                   workload=as_cell_workload(reqs), deadline_s=0.1)
    ], cloud_servers=1)
    table = FleetGateTable.from_logits(exits, final, plan, labels=y, backend=TORCH_CPU)
    assert near_boundary(table.conf, [0.8]) == 0
    ftel = FleetSimulator(table, topo, profile, config=FleetConfig(window_s=0.5)).run()

    f = ftel.fleet_summary()
    s = tel.summary()
    assert f["requests"] == s["requests"]
    assert f["offload_rate"] == pytest.approx(s["offload_rate"], abs=0)
    assert f["accuracy"] == pytest.approx(s["accuracy"], abs=0)
    ev = np.sort(tel.latencies())
    fl = np.sort(ftel._cells[0].column("latency_s"))
    np.testing.assert_allclose(fl, ev, rtol=1e-9, atol=1e-12)
    assert f["p99_ms"] == pytest.approx(s["p99_ms"], rel=1e-9)
    assert f["mean_ms"] == pytest.approx(s["mean_ms"], rel=1e-9)
    assert f["deadline_miss_rate"] == pytest.approx(s["deadline_miss_rate"], abs=0)

    from repro.core.calibration import TemperatureScaling as JTS
    from repro.fleet.topology import CellConfig as JCell
    from repro.fleet.topology import CellWorkload as JWorkload
    from repro.fleet.topology import FleetTopology as JTopology
    from repro.offload import latency as JL
    from repro.serving.network import FixedRateNetwork as JFixed

    jplan = JPlan(p_tar=0.8, calibrators=[JTS.from_temperature(1.0)] * 2)
    wl = as_cell_workload(reqs)
    jtopo = JTopology([JCell(network=JFixed(profile.uplink_bps),
                             workload=JWorkload(wl.arrival_s, wl.sample, wl.device),
                             deadline_s=0.1)], cloud_servers=1)
    jtel = JFleetSimulator(JGateTable.from_logits(exits, final, jplan, labels=y), jtopo,
                           JL.paper_2020(), config=JFleetConfig(window_s=0.5)).run()
    same_fleet(ftel, jtel)


def test_fleet_matches_closed_form(cascade):
    """Empty queues + fixed link: every latency equals the paper's
    closed-form edge / edge+comm+cloud sums."""
    exits, final, y, plan, profile = cascade
    n = len(y)
    reqs = constant_workload(10.0, n, n)
    topo = FleetTopology([
        CellConfig(network=FixedRateNetwork(profile.uplink_bps),
                   workload=as_cell_workload(reqs))
    ])
    table = FleetGateTable.from_logits(exits, final, plan, labels=y, backend="numpy")
    tel = FleetSimulator(table, topo, profile).run()
    lat = tel._cells[0].column("latency_s")
    on = tel._cells[0].column("on_device")
    t_edge = L.edge_time(profile, 1)
    t_cloud = t_edge + L.comm_time(profile, 1) + L.cloud_time(profile, 1)
    np.testing.assert_allclose(lat[on], t_edge, rtol=1e-9)
    np.testing.assert_allclose(lat[~on], t_cloud, rtol=1e-9)


def test_fleet_matches_event_runtime_under_drift(drift_data):
    """Single-cell limit with a PlanBank + Markov context schedule: expert
    selection, per-context telemetry, and the miscalibration gap agree
    with ContextualLogitsCore under the event runtime."""
    val, test, (uncal, global_plan, bank), _ = drift_data
    profile = L.paper_2020()
    n = len(test["labels"])
    reqs = poisson_workload(40.0, 900, n, deadline_s=0.1, seed=7)
    core = ContextualLogitsCore(
        test["exit_logits"], test["final"], bank, tscn.severity_drift_schedule(),
        labels=test["labels"], features_by_context=test["features"], backend=TORCH_CPU,
    )
    tel = ServingRuntime(core, profile, bank, reqs, config=RuntimeConfig(max_batch=1)).run()

    topo = FleetTopology([
        CellConfig(network=FixedRateNetwork(profile.uplink_bps),
                   workload=as_cell_workload(reqs),
                   schedule=tscn.severity_drift_schedule(), deadline_s=0.1)
    ])
    table = FleetGateTable(
        test["exit_logits"], test["final"], bank,
        labels=test["labels"], features_by_context=test["features"], backend=TORCH_CPU,
    )
    ftel = FleetSimulator(table, topo, profile).run()
    s, f = tel.summary(), ftel.fleet_summary()
    assert f["offload_rate"] == pytest.approx(s["offload_rate"], abs=0)
    assert f["accuracy"] == pytest.approx(s["accuracy"], abs=0)
    assert f["p99_ms"] == pytest.approx(s["p99_ms"], rel=1e-9)
    assert f["miscalibration_gap"] == pytest.approx(s["miscalibration_gap"], abs=1e-12)
    ev_ctx = tel.per_context_summary()
    fl_ctx = ftel.per_context_summary()
    assert set(fl_ctx) == set(ev_ctx)
    for ctx in ev_ctx:
        for k in ("requests", "offload_rate", "on_device_accuracy",
                  "miscalibration_gap", "est_match_rate"):
            assert fl_ctx[ctx][k] == pytest.approx(ev_ctx[ctx][k], abs=1e-12), (ctx, k)


# ----------------------------------------------------------- determinism
def test_fleet_deterministic_under_seed(drift_data):
    val, test, (uncal, global_plan, bank), _ = drift_data

    def run(seed):
        scn = reference_fleet(n_cells=8, requests_per_cell=200, seed=seed, val=val, test=test)
        return run_fleet(bank, scn, with_controller=True, backend=TORCH_CPU).fleet_summary()

    a, b = run(0), run(0)
    assert a == b  # bit-identical, dicts and all
    c = run(1)
    assert c["p99_ms"] != a["p99_ms"]  # the seed genuinely matters


def test_reference_fleet_topology_matches_reference(drift_data):
    """The same seed gives the same fleet in both packages: arrivals,
    samples, devices, links and weather, cell for cell."""
    val, test = drift_data[:2]
    scn = reference_fleet(n_cells=16, requests_per_cell=100, val=val, test=test, seed=3)
    jscn_ = jreference_fleet(n_cells=16, requests_per_cell=100, val=val, test=test, seed=3)
    assert scn.contexts == jscn_.contexts
    times = np.linspace(0.0, 12.0, 97)
    for cell, jcell in zip(scn.topology.cells, jscn_.topology.cells):
        for f in ("arrival_s", "sample", "device"):
            np.testing.assert_array_equal(getattr(cell.workload, f), getattr(jcell.workload, f))
        np.testing.assert_array_equal(cell.network.rates_bps(times),
                                      jcell.network.rates_bps(times))
        np.testing.assert_array_equal(cell.schedule.context_ids_at(times),
                                      jcell.schedule.context_ids_at(times))
        assert (cell.n_devices, cell.deadline_s) == (jcell.n_devices, jcell.deadline_s)
    assert scn.topology.horizon_s == jscn_.topology.horizon_s
    for c in (0, 5, 15):
        np.testing.assert_array_equal(scn.topology.shed_order(c),
                                      jscn_.topology.shed_order(c))


def test_vectorized_network_and_schedule_lookups():
    """rates_bps / context_ids_at agree with the scalar paths at every
    query point, in any order."""
    times = np.linspace(0.0, 30.0, 301)
    for net in (
        FixedRateNetwork(5e6),
        MarkovNetwork(seed=3, dwell_s=0.7),
        TraceNetwork([0.0, 4.0, 6.0], [1e6, 2e6, 3e6], period_s=10.0),
    ):
        vec = net.rates_bps(times)
        scalar = [net.rate_bps(float(t)) for t in times]
        np.testing.assert_array_equal(vec, scalar)
    sch = MarkovContextSchedule(["a", "b", "c"], dwell_s=0.9, seed=5)
    ids = sch.context_ids_at(times)
    keys = [sch.contexts[i] for i in ids]
    assert keys == [sch.context_at(float(t)) for t in times]


# ----------------------------------------------------- batched gate path
def test_gate_block_matches_logits_core(cascade):
    exits, final, y, plan, profile = cascade
    core = LogitsCore(exits, final, plan, labels=y, device="cpu")
    for b in (1, 2):
        conf, pred = plan.gate_block(exits[b], branch=b - 1, backend=TORCH_CPU)
        np.testing.assert_array_equal(conf, core.conf[b])
        np.testing.assert_array_equal(pred, core.pred[b])


def test_bank_gate_block_matches_per_sample_selection(drift_data):
    """PlanBank.gate_block under estimator ids == gating each sample with
    its own expert plan."""
    val, test, (uncal, global_plan, bank), _ = drift_data
    ctx = "gaussian_noise@2"
    z = test["exit_logits"][ctx][1]
    feats = test["features"][ctx]
    conf, pred, eids = bank.gate_block(z, features=feats, branch=0, backend="numpy")
    keys = bank.contexts
    for i in range(0, len(z), 97):  # spot-check a spread of samples
        plan = bank.plan_for(keys[eids[i]]) if eids[i] >= 0 else bank.default_plan
        c, p = plan.gate_block(z[i:i + 1], branch=0, backend="numpy")
        assert conf[i] == c[0]
        assert pred[i] == p[0]


# ------------------------------------------------------ fleet controller
def test_rescore_plan_sample_weight():
    """Weighting the validation samples moves offload probability and
    accuracy exactly as the weighted mixture dictates."""
    exits, final, y = tscn.synthetic_cascade_logits(256)
    plan = OffloadPlan(p_tar=0.8, calibrators=[TemperatureScaling.from_temperature(1.0)] * 2)
    kw = dict(
        edge_times_s=[1e-3, 2e-3], cloud_times_s=[5e-3, 4e-3],
        payload_bytes=[65536, 24576], uplink_bps=1e7,
        labels=y, final_logits=final, device="cpu",
    )
    _, table_u = rescore_plan(plan, [exits[1], exits[2]], **kw)
    w = np.zeros(256)
    w[:64] = 1.0  # price only the first quarter of the traffic
    _, table_w = rescore_plan(plan, [exits[1], exits[2]], sample_weight=w, **kw)
    row_u = next(r for r in table_u if r["exit_index"] == 0)
    row_w = next(r for r in table_w if r["exit_index"] == 0)
    conf, _ = plan.gate_block(exits[1], branch=0, backend="numpy")
    expect = float((conf[:64] < 0.8).mean())
    assert row_w["offload_prob"] == pytest.approx(expect)
    assert row_w["offload_prob"] != row_u["offload_prob"]
    with pytest.raises(ValueError):
        rescore_plan(plan, [exits[1], exits[2]], sample_weight=-np.ones(256), **kw)


def _offload_at(bank, val, branch, p_tar):
    # mean offload over contexts under each context's expert calibrator
    offs = []
    for ctx, z in val["exit_logits"].items():
        conf, _ = bank.plan_for(ctx).gate_block(z[branch], branch=branch - 1, backend="numpy")
        offs.append(float((conf < p_tar).mean()))
    return float(np.mean(offs))


class _FixedTel:
    """Telemetry stub: per-cell bandwidth, a fixed arrival rate and a
    uniform traffic mix."""

    def __init__(self, context_keys, bandwidths, rate_hz):
        self.context_keys = context_keys
        self.bandwidths = bandwidths
        self.rate_hz = rate_hz

    def bandwidth_estimate(self, c, w, now):
        return self.bandwidths[c % len(self.bandwidths)]

    def arrival_rate_estimate(self, c, w, now):
        return self.rate_hz

    def context_mix_estimate(self, c, w, now):
        k = len(self.context_keys)
        return np.full(k, 1.0 / k)


def test_fleet_controller_concedes_only_under_distress(drift_data):
    """A cell on the nominal link holds the plan's p_tar; a cell whose
    measured uplink cannot carry full-p_tar traffic makes the weakest
    stable concession; the decisions equal the reference controller's."""
    from repro.fleet import FleetController as JFleetController
    from repro.offload import latency as JL

    val, test, (uncal, global_plan, bank), (_, _, jbank) = drift_data
    profile = L.paper_2020()
    cfg = dict(interval_s=1.0, window_s=2.0, p_tar_grid=(0.3, 0.5, 0.7, 0.8), min_accuracy=0.8)
    ctrl = FleetController(bank, profile, val["exit_logits"], n_cells=2,
                           final_logits=val["final"], labels=val["labels"], cloud_servers=4,
                           config=FleetControllerConfig(**cfg), backend=TORCH_CPU)
    tel = _FixedTel(sorted(test["exit_logits"]), [profile.uplink_bps, 1.5e6], 20.0)
    decisions = ctrl.update(1.0, tel)
    (b0, p0, l0), (b1, p1, l1) = decisions
    assert l0 == 0 and l1 == 0  # no codec axis configured: level 0 held
    assert p0 == bank.default_plan.p_tar  # healthy link: contract held
    assert p1 < bank.default_plan.p_tar  # distressed link: conceded
    assert p1 in (0.3, 0.5, 0.7)
    for p in (0.5, 0.7):
        if p <= p1:
            continue
        for branch in (1, 2):
            payload = [65536, 24576][branch - 1]
            util = 20.0 * _offload_at(bank, val, branch, p) * payload * 8 / 1.5e6
            assert util >= 0.95, (p, branch, util)
    jctrl = JFleetController(jbank, JL.paper_2020(), val["exit_logits"], n_cells=2,
                             final_logits=val["final"], labels=val["labels"], cloud_servers=4,
                             config=JFCC(**cfg))
    assert jctrl.update(1.0, tel) == decisions


def test_fleet_controller_shared_cloud_cap(drift_data):
    """With a tiny shared cloud, the aggregate-utilization pass demotes
    cells relative to the uncapped decisions."""
    val, test, (uncal, global_plan, bank), _ = drift_data
    profile = L.paper_2020()

    def decisions(rho_max):
        ctrl = FleetController(
            bank, profile, val["exit_logits"], n_cells=8,
            final_logits=val["final"], labels=val["labels"], cloud_servers=1,
            config=FleetControllerConfig(p_tar_grid=(0.3, 0.5, 0.8), min_accuracy=0.8,
                                         cloud_rho_max=rho_max),
            backend="numpy",
        )
        # gentle enough that every uplink stays stable at full p_tar (no
        # distress concession), so any demotion comes from the cloud pass
        return ctrl.update(1.0, _FixedTel(sorted(test["exit_logits"]),
                                          [profile.uplink_bps], 40.0))

    free = decisions(rho_max=None)
    capped = decisions(rho_max=0.01)
    total_off_free = sum(_offload_at(bank, val, b, p) for b, p, _ in free)
    total_off_capped = sum(_offload_at(bank, val, b, p) for b, p, _ in capped)
    assert total_off_capped < total_off_free


def test_row_feasible_all_offload_vacuously_holds_gap():
    """A candidate that offloads everything keeps nothing on-device, so
    the reliability-gap cap is vacuously satisfied; an unknown gap on a
    row that DOES keep samples on-device stays infeasible."""
    from repro_torch.core.control import row_feasible, select_candidate

    all_off = dict(exit_index=0, p_tar=0.99, offload_prob=1.0,
                   expected_latency_s=0.09, uplink_utilization=0.1,
                   accuracy=0.95, on_device_accuracy=None, reliability_gap=None)
    broken = dict(all_off, p_tar=0.8, offload_prob=0.4, expected_latency_s=0.01,
                  on_device_accuracy=0.55, reliability_gap=0.25)
    unknown = dict(all_off, offload_prob=0.4)
    assert row_feasible(all_off, max_reliability_gap=0.05)
    assert not row_feasible(broken, max_reliability_gap=0.05)
    assert not row_feasible(unknown, max_reliability_gap=0.05)
    best = select_candidate([broken, all_off], max_reliability_gap=0.05)
    assert best is all_off


# ------------------------------------------------------ diurnal envelope
def test_diurnal_envelope_workload():
    """envelope=None stays bit-identical to the homogeneous stream; an
    envelope produces a deterministic, sorted, exactly-n stream whose
    arrivals concentrate in the high-rate phase -- the reference's
    stream, draw for draw."""
    flat = poisson_cell_workload(20.0, 2000, 512, seed=5)
    off = poisson_cell_workload(20.0, 2000, 512, seed=5, envelope=None)
    np.testing.assert_array_equal(flat.arrival_s, off.arrival_s)

    env = DiurnalEnvelope(period_s=40.0, amplitude=0.8)
    wl = poisson_cell_workload(20.0, 2000, 512, seed=5, envelope=env)
    wl2 = poisson_cell_workload(20.0, 2000, 512, seed=5, envelope=env)
    np.testing.assert_array_equal(wl.arrival_s, wl2.arrival_s)
    assert len(wl) == 2000
    assert np.all(np.diff(wl.arrival_s) >= 0)
    frac_high = float((env.rate_factor(wl.arrival_s) > 1.0).mean())
    assert frac_high > 0.65, frac_high
    assert float((env.rate_factor(flat.arrival_s) > 1.0).mean()) < frac_high
    DiurnalEnvelope(amplitude=1.0)
    with pytest.raises(ValueError, match="amplitude"):
        DiurnalEnvelope(amplitude=1.1)
    with pytest.raises(ValueError, match="period"):
        DiurnalEnvelope(period_s=0.0)
    jwl = jpoisson_cell_workload(20.0, 2000, 512, seed=5,
                                 envelope=JEnvelope(period_s=40.0, amplitude=0.8))
    np.testing.assert_array_equal(wl.arrival_s, jwl.arrival_s)
    np.testing.assert_array_equal(
        flat.arrival_s, jpoisson_cell_workload(20.0, 2000, 512, seed=5).arrival_s)


# --------------------------------------------------------- validation
def test_fleet_validation_errors(cascade):
    exits, final, y, plan, profile = cascade
    table = FleetGateTable.from_logits(exits, final, plan, labels=y, backend="numpy")
    wl = poisson_cell_workload(10.0, 50, len(y))
    cell = CellConfig(network=FixedRateNetwork(1e7), workload=wl)
    with pytest.raises(ValueError, match="at least one cell"):
        FleetTopology([])
    with pytest.raises(ValueError, match="window_s"):
        FleetSimulator(table, FleetTopology([cell]), profile, config=FleetConfig(window_s=0.0))
    with pytest.raises(ValueError, match="device"):
        CellConfig(network=FixedRateNetwork(1e7),
                   workload=poisson_cell_workload(10.0, 50, len(y), n_devices=4),
                   n_devices=2)
    entropy_plan = OffloadPlan(p_tar=0.8, calibrators=list(plan.calibrators),
                               criterion="entropy", entropy_threshold=0.5)
    with pytest.raises(ValueError, match="criteri"):
        FleetGateTable.from_logits(exits, final, entropy_plan, backend="numpy")
    ctrl = FleetController(plan, profile, exits, n_cells=1, backend="numpy")
    with pytest.raises(ValueError, match="multiple"):
        FleetSimulator(table, FleetTopology([cell]), profile,
                       config=FleetConfig(window_s=0.3), controller=ctrl)


def test_compiled_backend_raises_without_fallback(drift_data, monkeypatch):
    """backend="compiled" raises before anything runs: no table is built
    and the host simulator never starts in its place."""
    from repro_torch.fleet import simulator

    val, test, (uncal, global_plan, bank), _ = drift_data
    scn = small_fleet(drift_data, n_cells=2, requests_per_cell=20)
    started = []
    monkeypatch.setattr(simulator.FleetSimulator, "run", lambda self: started.append(self))
    monkeypatch.setattr(simulator.GateTable, "__init__",
                        lambda self, *a, **k: started.append(self))
    for with_controller in (False, True):
        with pytest.raises(NotImplementedError, match="compiled-fleet slice"):
            run_fleet(bank, scn, with_controller=with_controller, backend="compiled")
    assert started == []


# ----------------------------------------------- acceptance at test scale
def test_fleet_acceptance_small(drift_data):
    """The acceptance direction at 16 cells: the controller rescues the
    calibrated fleet's tail (vs the bank served statically) and beats the
    uncalibrated plan on the miscalibration gap without giving up its
    accuracy win."""
    val, test, (uncal, global_plan, bank), _ = drift_data
    scn = reference_fleet(n_cells=16, requests_per_cell=400, val=val, test=test)
    u = run_fleet(uncal, scn, backend="numpy").fleet_summary()
    b = run_fleet(bank, scn, backend="numpy").fleet_summary()
    c = run_fleet(bank, scn, with_controller=True, backend="numpy").fleet_summary()
    assert c["miscalibration_gap"] < 0.6 * u["miscalibration_gap"]
    assert c["p99_ms"] < 0.5 * b["p99_ms"]
    assert c["accuracy"] > u["accuracy"]


@pytest.mark.slow
def test_fleet_acceptance_controller_beats_uncal(drift_data):
    """The full-size acceptance criterion (>=100k requests across >=64
    cells; the calibrated fleet controller beats the static uncalibrated
    plan on fleet p99 AND miscalibration gap), and the port's runs equal
    the reference's at that size."""
    val, test, (uncal, global_plan, bank), (juncal, _, jbank) = drift_data
    scn = reference_fleet(val=val, test=test)
    jscn_ = jreference_fleet(val=val, test=test)
    assert scn.topology.n_cells >= 64 and scn.topology.n_requests >= 100_000
    u = run_fleet(uncal, scn, backend="numpy")
    c = run_fleet(bank, scn, with_controller=True, backend="numpy")
    same_fleet(u, jrun_fleet(juncal, jscn_))
    same_fleet(c, jrun_fleet(jbank, jscn_, with_controller=True))
    u, c = u.fleet_summary(), c.fleet_summary()
    assert c["p99_ms"] < 0.8 * u["p99_ms"], (c["p99_ms"], u["p99_ms"])
    assert c["miscalibration_gap"] < 0.6 * u["miscalibration_gap"]
    assert c["accuracy"] > u["accuracy"]


# ------------------------------------------------ against the reference
def _arm(name, plans, pkg):
    """(plan or bank, run_fleet kwargs) of one arm; `pkg` picks the
    controller-config class."""
    uncal, global_plan, bank = plans
    cfg = JFCC if pkg == "ref" else FleetControllerConfig
    if name == "static_uncalibrated":
        return uncal, {}
    if name == "expert_bank_static":
        return bank, {}
    if name == "expert_bank_controller":
        return bank, dict(with_controller=True)
    if name == "compression_aware":  # benchmarks/run.py's _comp_fleet_arm((0, 1, 2))
        return bank, dict(with_controller=True, controller_config=cfg(
            interval_s=1.0, window_s=2.0, p_tar_grid=(0.3, 0.5, 0.7, 0.8),
            min_accuracy=0.8, cloud_rho_max=0.9, compression_levels=(0, 1, 2)))
    if name == "global_level2":
        return global_plan.with_compression(2), {}
    raise AssertionError(name)


ARMS = ["static_uncalibrated", "expert_bank_static", "expert_bank_controller",
        "compression_aware", "global_level2"]


@pytest.mark.parametrize("arm", ARMS)
def test_fleet_matches_reference(drift_data, arm):
    """A 16-cell reference fleet through both packages: every per-request
    column, the fleet, per-cell and per-context summaries and the
    controller's switches agree (the port on its torch gate path on the
    CPU)."""
    val, test, plans, jplans = drift_data
    scn = reference_fleet(n_cells=16, requests_per_cell=400, val=val, test=test)
    jscn_ = jreference_fleet(n_cells=16, requests_per_cell=400, val=val, test=test)
    p, kw = _arm(arm, plans, "port")
    jp, jkw = _arm(arm, jplans, "ref")
    tel = run_fleet(p, scn, backend=TORCH_CPU, **kw)
    jtel = jrun_fleet(jp, jscn_, **jkw)
    same_fleet(tel, jtel)
    s = tel.fleet_summary()
    assert s["requests"] == 16 * 400 and 0.0 < s["offload_rate"] < 1.0
    if kw.get("with_controller"):
        assert s["controller_switches"] > 0
    if arm == "compression_aware":  # the controller did move a cell's codec level
        assert any(ev[4] != 0 for ev in tel.controller_events)


def test_fleet_with_its_own_plans_close_to_reference(drift_data):
    """The port fits its own plans on the CPU (T within hazard c of the
    reference's): the 16-cell fleet summaries stay close to the
    reference's, and the expert bank still beats the uncalibrated plan on
    the gap by the reference's margin."""
    val, test, _, jplans = drift_data
    own = tscn.fit_drift_plans(val, device="cpu")
    for a, b in zip(own[:2], jplans[:2]):
        np.testing.assert_allclose(a.temperatures, b.temperatures, rtol=2e-4)
    scn = reference_fleet(n_cells=16, requests_per_cell=400, val=val, test=test)
    jscn_ = jreference_fleet(n_cells=16, requests_per_cell=400, val=val, test=test)
    gaps = {}
    for arm in ("static_uncalibrated", "expert_bank_controller"):
        p, kw = _arm(arm, own, "port")
        jp, jkw = _arm(arm, jplans, "ref")
        s = run_fleet(p, scn, backend="numpy", **kw).fleet_summary()
        j = jrun_fleet(jp, jscn_, **jkw).fleet_summary()
        assert s["requests"] == j["requests"]
        for k in ("offload_rate", "accuracy", "miscalibration_gap", "deadline_miss_rate"):
            assert s[k] == pytest.approx(j[k], abs=2e-3), (arm, k)
        gaps[arm] = s["miscalibration_gap"]
    assert gaps["expert_bank_controller"] < 0.6 * gaps["static_uncalibrated"]


def test_fleet_simulator_backend_parity(drift_data):
    """The same ~2k-request fleet over the numpy and the torch gate
    backends (the torch one on the CPU) gives the same telemetry."""
    val, test, (uncal, global_plan, bank), _ = drift_data
    scn = reference_fleet(n_cells=4, requests_per_cell=500, val=val, test=test)
    a = run_fleet(bank, scn, backend="numpy")
    b = run_fleet(bank, scn, backend=TORCH_CPU)
    same_fleet(a, b)
    assert a.fleet_summary()["requests"] == 2000


# ------------------------------------------------------- observability
def test_fleet_obs_is_bit_exact(drift_data):
    scn = small_fleet(drift_data)
    bank = drift_data[2][2]
    bare = run_fleet(bank, scn, with_controller=True, backend=TORCH_CPU).fleet_summary()
    obs = full_observability()
    wired = run_fleet(bank, scn, with_controller=True, obs=obs,
                      backend=TORCH_CPU).fleet_summary()
    assert bare == wired
    assert len(obs.trace) == scn.topology.n_requests


def test_fleet_unsampled_trace_conserves(drift_data):
    scn = small_fleet(drift_data)
    obs = full_observability(trace_sample_every=1)
    run_fleet(drift_data[2][2], scn, with_controller=True, obs=obs, backend="numpy")
    recs = obs.trace.records
    assert run_checks(recs, obs.metrics, obs.audit.records) == []
    assert len(recs) == scn.topology.n_requests
    m = obs.metrics
    assert m.gauge_value("fleet_requests_completed") == scn.topology.n_requests
    assert m.counter_total("fleet_requests_total") == scn.topology.n_requests
    n_off = sum(1 for r in recs if not r["on_device"])
    assert m.counter_total("fleet_offloaded_total") == n_off


def test_fleet_sampled_trace(drift_data):
    scn = small_fleet(drift_data)
    obs = full_observability(trace_sample_every=7)
    run_fleet(drift_data[2][2], scn, obs=obs, backend="numpy")
    recs = obs.trace.records
    n = scn.topology.n_requests
    assert len(recs) == math.ceil(n / 7)
    ids = [r["req_id"] for r in recs]
    assert len(set(ids)) == len(ids)
    assert run_checks(recs, obs.metrics, obs.audit.records) == []


def test_churn_run_traces_shed_and_conserves(drift_data):
    """Requests shed to a neighbor under churn stay conserved and traced;
    the audit log shows where each shed window was routed."""
    scn = small_fleet(drift_data)
    churn = ChurnSchedule.outage([0, 2], start_s=2.0, duration_s=4.0)
    obs = full_observability(trace_sample_every=1)
    run_fleet(drift_data[2][2], scn, with_controller=True,
              orchestrator=Orchestrator(churn=churn), obs=obs, backend=TORCH_CPU)
    assert run_checks(obs.trace.records, obs.metrics, obs.audit.records) == []
    sheds = obs.audit.filter(action="shed_route")
    assert sheds and all(
        not s["evidence"]["backhaul"] and s["evidence"]["host_cell"] is not None
        for s in sheds
    )
    assert obs.metrics.counter_total("fleet_shed_total") == sum(
        s["evidence"]["requests"] for s in sheds
    )


def test_whole_fleet_outage_backhaul_traced(drift_data):
    """With every cell down, windows backhaul straight to the cloud: the
    trace shows gate=None offloaded timelines that still telescope, and
    conservation holds."""
    scn = small_fleet(drift_data)
    churn = ChurnSchedule.outage(list(range(scn.topology.n_cells)), start_s=2.0,
                                 duration_s=3.0)
    obs = full_observability(trace_sample_every=1)
    run_fleet(drift_data[2][2], scn, orchestrator=Orchestrator(churn=churn), obs=obs,
              backend="numpy")
    recs = obs.trace.records
    assert run_checks(recs, obs.metrics, obs.audit.records) == []
    backhauled = [r for r in recs if r["gate"] is None]
    assert backhauled and all(not r["on_device"] for r in backhauled)
    assert len(recs) == scn.topology.n_requests


def _same_record(a, b):
    """Two trace records: equal, except the gate confidence, which agrees
    to the gate tolerance."""
    a, b = copy.deepcopy(a), copy.deepcopy(b)
    if a.get("gate") is not None and b.get("gate") is not None:
        assert a["gate"].pop("confidence") == pytest.approx(b["gate"].pop("confidence"),
                                                            **CONF_TOL)
    return a == b


def test_fleet_artifacts_equal_reference(drift_data):
    """A churned, controlled 6-cell fleet with every sink on, through both
    packages: trace and audit records, metrics and the calibration
    sketch agree (confidence-carrying numbers to the gate tolerance,
    everything else equal)."""
    _, _, (_, _, bank), (_, _, jbank) = drift_data
    scn = small_fleet(drift_data)
    jscn_ = small_fleet(drift_data, ref=True)
    obs, jobs = full_observability(trace_sample_every=3), jfull(trace_sample_every=3)
    tel = run_fleet(bank, scn, with_controller=True, obs=obs, backend=TORCH_CPU,
                    orchestrator=Orchestrator(churn=ChurnSchedule.outage([1], 2.0, 3.0)))
    jtel = jrun_fleet(jbank, jscn_, with_controller=True, obs=jobs,
                      orchestrator=JOrchestrator(churn=JChurn.outage([1], 2.0, 3.0)))
    same_fleet(tel, jtel)
    recs, jrecs = obs.trace.records, jobs.trace.records
    assert len(recs) == len(jrecs) == math.ceil(scn.topology.n_requests / 3)
    assert all(_same_record(a, b) for a, b in zip(recs, jrecs))
    assert len(obs.audit) == len(jobs.audit) > 0
    assert all(json.dumps(a) == json.dumps(b)
               for a, b in zip(obs.audit.records, jobs.audit.records))
    got, want = obs.metrics.to_json(), jobs.metrics.to_json()
    assert got["counters"] == want["counters"]
    assert set(got["histograms"]) == set(want["histograms"])
    for name, rows in got["histograms"].items():
        jrows = want["histograms"][name]
        assert len(rows) == len(jrows)
        for r, jr in zip(rows, jrows):
            r, jr = dict(r), dict(jr)
            # a histogram's sum carries confidences or latencies; its
            # counts are decisions
            tol = CONF_TOL if name == "calibration_confidence" else dict(rel=1e-9, abs=0)
            assert r.pop("sum") == pytest.approx(jr.pop("sum"), **tol), name
            assert r == jr, name
    assert set(got["gauges"]) == set(want["gauges"])
    for name in got["gauges"]:
        rows, jrows = got["gauges"][name], want["gauges"][name]
        assert [r["labels"] for r in rows] == [r["labels"] for r in jrows]
        tol = CONF_TOL if name in CONF_FAMILIES else dict(rel=1e-9 if "_ms" in name else 0,
                                                          abs=0)
        assert [r["value"] for r in rows] == pytest.approx([r["value"] for r in jrows],
                                                           nan_ok=True, **tol), name
    assert obs.calibration.keys() == jobs.calibration.keys()
    for key in obs.calibration.keys():
        a, b = obs.calibration.block(*key), jobs.calibration.block(*key)
        np.testing.assert_array_equal(a[[0, 1, 5, 6]], b[[0, 1, 5, 6]])
        np.testing.assert_allclose(a[2:5], b[2:5], rtol=2e-5, atol=1e-6 * a[0].sum())
