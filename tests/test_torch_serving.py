"""Port parity for the event-driven serving runtime
(`repro_torch.serving.{workload,telemetry,controller,runtime,drift,
scenarios}`) against `repro.serving` on the CPU: the same numpy inputs go
through both packages, and the port also passes the reference's own
assertions (tests/test_serving.py, without the LM case).

Tolerances:
* request lists, per-request records and `Telemetry.summary()`: equal
  (``==``; every float the port computes is the reference's host numpy
  on the same decisions), except EngineCore against LogitsCore, whose
  latencies agree to rel 1e-12 as the reference demands;
* gate decisions: exact away from p_tar +- 1e-6 (K1's boundary, ROADMAP
  hazard d); each case counts the samples inside that band, and these
  data hold none;
* rescore_plan: the same winner and the same rows.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.calibration import TemperatureScaling as JTS
from repro.core.policy import OffloadPlan as JPlan
from repro.models import convnet as jconv
from repro.offload import latency as JL
from repro.offload.engine import convnet_engine as jengine
from repro.serving import runtime as jrt
from repro.serving import scenarios as jscn
from repro.serving import workload as jwl
from repro.serving.controller import ControllerConfig as JCC
from repro.serving.controller import OnlineController as JOC
from repro.serving.network import FixedRateNetwork as JFixed
from repro.serving.network import MarkovNetwork as JMarkov
from repro_torch.core.bank import PlanBank
from repro_torch.core.calibration import TemperatureScaling
from repro_torch.core.control import windowed_mean
from repro_torch.core.policy import OffloadPlan, rescore_plan
from repro_torch.models import convnet
from repro_torch.models.convnet import payload_bytes
from repro_torch.offload import latency as L
from repro_torch.offload.engine import convnet_engine
from repro_torch.offload.simulator import simulate_batches
from repro_torch.serving import (
    ControllerConfig,
    EngineCore,
    FixedRateNetwork,
    LogitsCore,
    MarkovNetwork,
    OnlineController,
    RuntimeConfig,
    ServingRuntime,
    Telemetry,
    constant_workload,
    poisson_workload,
    trace_workload,
)
from repro_torch.serving import scenarios as tscn

ROOT = Path(__file__).resolve().parents[1]
BOUNDARY = 1e-6  # K1's boundary band around p_tar (hazard d)


def near_boundary(conf, p_tars) -> int:
    """How many confidences sit within BOUNDARY of any of `p_tars`."""
    c = np.asarray(conf, np.float64).ravel()
    return int(sum((np.abs(c - p) <= BOUNDARY).sum() for p in p_tars))


def records(tel):
    """Every stored field of every record, in completion order."""
    return [tuple(vars(r).items()) for r in tel.records]


def same_summary(a, b):
    """Equal summaries, nan matching nan (a run without deadlines): JSON
    writes each float's shortest exact repr, so equal text is equal
    values."""
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def same_run(t_port, t_ref):
    assert records(t_port) == records(t_ref)
    same_summary(t_port.summary(), t_ref.summary())
    assert t_port.controller_events == t_ref.controller_events
    assert t_port.bandwidth_samples == t_ref.bandwidth_samples


@pytest.fixture(scope="module")
def setup():
    exits, final, y = tscn.synthetic_cascade_logits()
    jexits, jfinal, jy = jscn.synthetic_cascade_logits()
    for b in (1, 2):  # the same generator, draw for draw
        np.testing.assert_array_equal(exits[b], jexits[b])
    np.testing.assert_array_equal(final, jfinal)
    plan = OffloadPlan(p_tar=0.8, calibrators=[TemperatureScaling.from_temperature(1.0)] * 2)
    jplan = JPlan(p_tar=0.8, calibrators=[JTS.from_temperature(1.0)] * 2)
    core = LogitsCore(exits, final, plan, labels=y, device="cpu")
    jcore = jrt.LogitsCore(exits, final, jplan, labels=y)
    for b in (1, 2):
        np.testing.assert_allclose(core.conf[b], jcore.conf[b], rtol=2e-5, atol=1e-6)
        np.testing.assert_array_equal(core.pred[b], jcore.pred[b])
    assert near_boundary(np.stack([core.conf[1], core.conf[2]]), [0.8]) == 0
    return dict(exits=exits, final=final, y=y, plan=plan, jplan=jplan, core=core,
                jcore=jcore, profile=L.paper_2020(), jprofile=JL.paper_2020())


def both(s, make):
    """Run `make(pkg)` for the port and the reference; pkg carries each
    package's runtime pieces."""
    port = dict(core=s["core"], plan=s["plan"], profile=s["profile"], RT=ServingRuntime,
                RC=RuntimeConfig, wl=dict(constant=constant_workload, poisson=poisson_workload),
                Fixed=FixedRateNetwork, Markov=MarkovNetwork, OC=OnlineController,
                CC=ControllerConfig, kw={"backend": "numpy"})
    ref = dict(core=s["jcore"], plan=s["jplan"], profile=s["jprofile"], RT=jrt.ServingRuntime,
               RC=jrt.RuntimeConfig, wl=dict(constant=jwl.constant_workload,
                                             poisson=jwl.poisson_workload),
               Fixed=JFixed, Markov=JMarkov, OC=JOC, CC=JCC, kw={})
    return make(port), make(ref)


# --------------------------------------------------- static special case
def test_runtime_reproduces_static_numbers(setup):
    """Empty queues + fixed link => the runtime IS the paper's closed-form
    model, request by request, and agrees with simulate_batches."""
    s = setup
    core, plan, profile, y = s["core"], s["plan"], s["profile"], s["y"]
    n = len(y)

    def make(p):
        reqs = p["wl"]["constant"](10.0, n, n)  # 100 ms spacing >> ~30 ms service
        return p["RT"](p["core"], p["profile"], p["plan"], reqs,
                       network=p["Fixed"](p["profile"].uplink_bps),
                       config=p["RC"](max_batch=1)).run()

    tel, jtel = both(s, make)
    same_run(tel, jtel)
    assert len(tel.records) == n
    t_edge = L.edge_time(profile, 1)
    t_cloud = t_edge + L.comm_time(profile, 1) + L.cloud_time(profile, 1)
    for r in tel.records:
        assert abs(r.latency_s - (t_edge if r.on_device else t_cloud)) < 1e-9
    outs = simulate_batches([s["exits"][1]], s["final"], y, profile=profile, plan=plan,
                            batch_size=n, branches=(1,), device="cpu")
    assert len(outs) == 1
    assert tel.offload_rate == pytest.approx(1.0 - outs[0].on_device_frac, abs=0)
    assert tel.accuracy == pytest.approx(outs[0].accuracy, abs=0)
    assert tel.latencies().mean() == pytest.approx(outs[0].time_s, rel=1e-9)


def test_runtime_deterministic(setup):
    s = setup

    def run():
        reqs = poisson_workload(50.0, 300, len(s["y"]), seed=4)
        rt = ServingRuntime(s["core"], s["profile"], s["plan"], reqs,
                            network=MarkovNetwork(seed=3),
                            config=RuntimeConfig(max_batch=4, batch_window_s=0.01))
        return rt.run().latencies()

    np.testing.assert_array_equal(run(), run())


# ---------------------------------------- queueing, batching, devices
def _queue_case(p, name):
    t_edge = L.edge_time(L.paper_2020(), 1)
    n = 512
    if name == "slow":
        return p["RT"](p["core"], p["profile"], p["plan"], p["wl"]["constant"](0.1 / t_edge, 200, n),
                       config=p["RC"](max_batch=1)).run()
    if name == "over_capacity":
        return p["RT"](p["core"], p["profile"], p["plan"], p["wl"]["constant"](2.0 / t_edge, 200, n),
                       config=p["RC"](max_batch=1)).run()
    if name.startswith("devices_"):
        d = int(name.split("_")[1])
        reqs = p["wl"]["constant"](3.0 / t_edge, 300, n, n_devices=4)
        return p["RT"](p["core"], p["profile"], p["plan"], reqs,
                       config=p["RC"](n_devices=d, max_batch=1)).run()
    if name == "microbatch":
        return p["RT"](p["core"], p["profile"], p["plan"], p["wl"]["poisson"](500.0, 400, n, seed=1),
                       config=p["RC"](max_batch=8, batch_window_s=0.05)).run()
    if name == "batch_window":
        return p["RT"](p["core"], p["profile"], p["plan"], p["wl"]["constant"](5.0, 40, n),
                       config=p["RC"](max_batch=64, batch_window_s=0.03)).run()
    if name == "summary":
        return p["RT"](p["core"], p["profile"], p["plan"],
                       p["wl"]["poisson"](100.0, 128, n, deadline_s=0.05, seed=2)).run()
    raise AssertionError(name)


CASES = ["slow", "over_capacity", "devices_1", "devices_4", "microbatch", "batch_window",
         "summary"]


@pytest.fixture(scope="module")
def queue_runs(setup):
    out = {}
    for name in CASES:
        out[name] = both(setup, lambda p: _queue_case(p, name))
    return out


@pytest.mark.parametrize("name", CASES)
def test_queueing_cases_match_reference(queue_runs, name):
    tel, jtel = queue_runs[name]
    same_run(tel, jtel)


def test_queueing_inflates_latency(queue_runs):
    """Arrivals near the service rate queue up; the closed-form model
    cannot see this, the event simulator must."""
    assert queue_runs["over_capacity"][0].p95_s > 2 * queue_runs["slow"][0].p95_s


def test_multi_device_spreads_load(queue_runs):
    assert queue_runs["devices_4"][0].p95_s < queue_runs["devices_1"][0].p95_s


def test_microbatcher_coalesces(queue_runs):
    """max_batch > 1 means fewer uplink transfers than offloaded samples."""
    tel = queue_runs["microbatch"][0]
    offloaded = sum(not r.on_device for r in tel.records)
    assert offloaded > 0
    assert len(tel.bandwidth_samples) < offloaded
    assert len(tel.records) == 400


def test_batch_window_flushes_partial_batch(queue_runs):
    tel = queue_runs["batch_window"][0]
    assert len(tel.records) == 40
    for r in tel.records:
        if not r.on_device:
            assert r.latency_s < 0.03 + 0.2


def test_telemetry_summary_json_safe(queue_runs):
    s = queue_runs["summary"][0].summary()
    json.dumps(s)
    assert s["requests"] == 128
    assert s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"]
    assert 0.0 <= s["offload_rate"] <= 1.0
    assert 0.0 <= s["deadline_miss_rate"] <= 1.0


# -------------------------------------------------------------- workload
@pytest.mark.parametrize("kind", ["poisson", "constant_random", "trace"])
def test_workload_generators_match_reference(kind):
    if kind == "poisson":
        args = ((100.0, 50, 20), dict(n_devices=3, deadline_s=0.1, seed=0))
        got, want = poisson_workload(*args[0], **args[1]), jwl.poisson_workload(*args[0], **args[1])
        arr = [r.arrival_s for r in got]
        assert arr == sorted(arr)
        assert [r.sample for r in got[:20]] == list(range(20))
        assert {r.device for r in got} == {0, 1, 2}
        assert all(r.deadline_s == 0.1 for r in got)
    elif kind == "constant_random":
        got = constant_workload(10.0, 5, 100, sample_order="random", seed=3)
        want = jwl.constant_workload(10.0, 5, 100, sample_order="random", seed=3)
        assert all(0 <= r.sample < 100 for r in got)
    else:
        got, want = trace_workload([0.0, 0.5, 0.5, 1.0], 4), jwl.trace_workload([0.0, 0.5, 0.5, 1.0], 4)
        assert [r.arrival_s for r in got] == [0.0, 0.5, 0.5, 1.0]
        with pytest.raises(ValueError):
            trace_workload([1.0, 0.5], 4)
    assert [vars(r) for r in got] == [vars(r) for r in want]


# ------------------------------------------------------------- telemetry
def test_telemetry_windowed_estimates():
    tel = Telemetry()
    assert tel.bandwidth_estimate(1.0, now=10.0) is None
    tel.observe_bandwidth(9.5, 4e6)
    tel.observe_bandwidth(5.0, 20e6)
    assert tel.bandwidth_estimate(1.0, now=10.0) == pytest.approx(4e6)
    assert tel.bandwidth_estimate() == pytest.approx(12e6)
    assert tel.bandwidth_estimate(1.0, now=20.0) == pytest.approx(4e6)
    assert tel.arrival_rate_estimate(1.0, now=10.0) is None
    for t in (9.2, 9.4, 9.6, 9.8, 4.0):
        tel.observe_arrival(t)
    assert tel.arrival_rate_estimate(1.0, now=10.0) == pytest.approx(4.0)


def test_windowed_estimators_future_only_fallback():
    """The stale-sample fallback also covers observations that all
    post-date `now`; None only when nothing was ever observed."""
    assert windowed_mean([7.0], [3e6], 0.5, now=1.0) == pytest.approx(3e6)
    assert windowed_mean([5.0, 9.0], [4e6, 2e6], 1.0, now=1.0) == pytest.approx(4e6)
    assert windowed_mean([0.5, 9.0], [5e6, 2e6], 1.0, now=2.0) == pytest.approx(5e6)
    assert windowed_mean([], [], 1.0, now=1.0) is None
    assert windowed_mean([7.0], [3e6], 0.5, now=1.0, stale_fallback=False) is None
    tel = Telemetry()
    tel.observe_bandwidth(9.5, 4e6)
    assert tel.bandwidth_estimate(1.0, now=1.0) == pytest.approx(4e6)
    assert tel.bandwidth_estimate(1.0, now=9.6) == pytest.approx(4e6)


def test_context_mix_excludes_unknown_verdicts():
    from repro.serving.telemetry import Telemetry as JTel

    tels = [Telemetry(), JTel()]
    for tel in tels:
        for t, c in [(0.1, "clean"), (0.2, "__unknown__"), (0.3, "contrast@3"),
                     (0.4, "clean"), (5.0, "clean")]:
            tel.observe_context(t, c)
    assert tels[0].context_mix_estimate(1.0, now=0.5) == tels[1].context_mix_estimate(1.0, now=0.5)
    assert tels[0].context_mix_estimate(1.0, now=0.5) == pytest.approx(
        {"clean": 2 / 3, "contrast@3": 1 / 3})


# ------------------------------------------------------- plan re-scoring
def _rescore_kw(s):
    p = s["profile"]
    return dict(edge_times_s=[L.edge_time(p, 1), L.edge_time(p, 2)],
                cloud_times_s=[L.cloud_time(p, 1), L.cloud_time(p, 2)],
                payload_bytes=[payload_bytes(1), payload_bytes(2)], device="cpu")


def test_rescore_plan_switches_under_bad_link(setup):
    """Under a starved uplink the small-payload deep exit wins; under the
    nominal link the shallow exit is fine (the reference's verdicts)."""
    from repro.core.policy import rescore_plan as jrescore

    s = setup
    z1, z2 = s["exits"][1], s["exits"][2]
    kw = dict(_rescore_kw(s), labels=s["y"], final_logits=s["final"], min_accuracy=0.9)
    jkw = {k: v for k, v in kw.items() if k != "device"}
    fast, _ = rescore_plan(s["plan"], [z1, z2], uplink_bps=1e9, **kw)
    slow, table = rescore_plan(s["plan"], [z1, z2], uplink_bps=1e5, **kw)
    jslow, jtable = jrescore(s["jplan"], [z1, z2], uplink_bps=1e5, **jkw)
    assert fast.exit_index == 0 and slow.exit_index == 1 == jslow.exit_index
    assert [(r["exit_index"], r["p_tar"], r["accuracy"]) for r in table] == \
        [(r["exit_index"], r["p_tar"], r["accuracy"]) for r in jtable]
    assert slow.calibrators is not s["plan"].calibrators
    assert slow.temperatures == s["plan"].temperatures


def test_rescore_plan_accuracy_floor(setup):
    s = setup
    best, _ = rescore_plan(
        s["plan"], [s["exits"][1], s["exits"][2]], edge_times_s=[1e-3, 2e-3],
        cloud_times_s=[5e-3, 4e-3], payload_bytes=[payload_bytes(1), payload_bytes(2)],
        uplink_bps=1e9, labels=s["y"], final_logits=s["final"], p_tar_grid=[0.0, 0.8],
        min_accuracy=1.1, device="cpu")
    assert best.p_tar == 0.8


def test_plan_with_p_tar_keeps_calibration(setup):
    plan = setup["plan"]
    moved = plan.with_p_tar(0.6)
    assert moved.p_tar == 0.6 and moved.temperatures == plan.temperatures
    assert moved.exit_index == plan.exit_index
    assert OffloadPlan.from_json(moved.to_json()).p_tar == 0.6
    assert JPlan.from_json(moved.to_json()).p_tar == 0.6


def test_rescore_plan_argument_validation(setup):
    s = setup
    z = [s["exits"][1], s["exits"][2]]
    kw = dict(edge_times_s=[1e-3, 2e-3], cloud_times_s=[5e-3, 4e-3],
              payload_bytes=[payload_bytes(1), payload_bytes(2)], uplink_bps=1e7, device="cpu")
    with pytest.raises(ValueError):
        rescore_plan(s["plan"], z, min_accuracy=0.9, **kw)
    entropy_plan = OffloadPlan(p_tar=0.8, calibrators=list(s["plan"].calibrators),
                               criterion="entropy", entropy_threshold=0.5)
    with pytest.raises(ValueError):
        rescore_plan(entropy_plan, z, **kw)


def test_rescore_plan_partition_layer_not_stale(setup):
    s = setup
    src = s["plan"].with_partition(0, 7)
    kw = dict(_rescore_kw(s), uplink_bps=1e5)
    moved, _ = rescore_plan(src, [s["exits"][1], s["exits"][2]], **kw)
    assert moved.exit_index == 1 and moved.partition_layer is None
    kept, _ = rescore_plan(src, [s["exits"][1], s["exits"][2]], exit_layer_indices=[0, 1], **kw)
    assert kept.partition_layer == 1


# ------------------------------------------------------------ the cores
def test_logits_core_entropy_criterion(setup):
    """LogitsCore honors the plan's entropy criterion, gate for gate with
    the reference's."""
    s = setup
    z1, final, y = s["exits"][1], s["final"], s["y"]
    cals = [TemperatureScaling.from_temperature(1.0)]
    plan = OffloadPlan(p_tar=0.8, calibrators=cals, criterion="entropy", entropy_threshold=0.5)
    jplan = JPlan(p_tar=0.8, calibrators=[JTS.from_temperature(1.0)], criterion="entropy",
                  entropy_threshold=0.5)
    core = LogitsCore({1: z1}, final, plan, labels=y, device="cpu")
    jcore = jrt.LogitsCore({1: z1}, final, jplan, labels=y)
    assert near_boundary(core.ent[1], [0.5]) == 0
    got = [core.gate(i, 1, 0.8)[0] for i in range(len(y))]
    assert got == [jcore.gate(i, 1, 0.8)[0] for i in range(len(y))]
    assert 0 < sum(got) < len(y)
    with pytest.raises(ValueError):
        LogitsCore({1: z1}, final, OffloadPlan(p_tar=0.8, calibrators=cals,
                                               criterion="entropy"), device="cpu")


@pytest.mark.parametrize("level", [1, 2])
def test_logits_core_codec_levels_match_reference(setup, level):
    """A non-zero level's cloud table round-trips the final logits through
    the port's codec: the reference oracle's predictions, sample for
    sample."""
    s = setup
    final = s["final"] + np.random.default_rng(level).normal(size=s["final"].shape).astype(
        np.float32) * 3
    core = LogitsCore(s["exits"], final, s["plan"], labels=s["y"], device="cpu")
    jcore = jrt.LogitsCore(s["exits"], final, s["jplan"], labels=s["y"])
    n = len(s["y"])
    assert [core.cloud_predict(i, 1, level) for i in range(n)] == \
        [jcore.cloud_predict(i, 1, level) for i in range(n)]


def test_runtime_rejects_controller_core_mismatch(setup):
    s = setup
    one_branch = LogitsCore({1: s["exits"][1]}, s["final"], s["plan"], labels=s["y"],
                            device="cpu")
    controller = OnlineController(s["plan"], s["profile"], s["exits"], final_logits=s["final"],
                                  labels=s["y"], backend="numpy")
    with pytest.raises(ValueError):
        ServingRuntime(one_branch, s["profile"], s["plan"], constant_workload(10.0, 10, 512),
                       controller=controller)


# ---------------------------------------------- controller under congestion
@pytest.fixture(scope="module")
def congestion(setup):
    s = setup
    out = {}
    for ctrl in (False, True):
        out[ctrl] = (
            tscn.run_congested_markov(s["plan"], s["exits"], s["final"], s["y"],
                                      with_controller=ctrl, profile=s["profile"],
                                      device="cpu"),
            jscn.run_congested_markov(s["jplan"], s["exits"], s["final"], s["y"],
                                      with_controller=ctrl, profile=s["jprofile"]))
    return out


@pytest.mark.parametrize("ctrl", [False, True])
def test_congestion_matches_reference(congestion, ctrl):
    same_run(*congestion[ctrl])


def test_controller_beats_static_under_congestion(congestion):
    static, ctrl = congestion[False][0], congestion[True][0]
    assert len(ctrl.controller_events) > 0
    assert ctrl.p99_s < 0.8 * static.p99_s
    assert ctrl.deadline_miss_rate <= static.deadline_miss_rate
    assert ctrl.accuracy >= static.accuracy - 0.01


def test_controller_settles_on_fixed_link(setup):
    s = setup

    def make(p):
        controller = p["OC"](p["plan"], p["profile"], s["exits"], final_logits=s["final"],
                             labels=s["y"], config=p["CC"](interval_s=1.0, window_s=2.0,
                                                           min_accuracy=0.9), **p["kw"])
        return p["RT"](p["core"], p["profile"], p["plan"], p["wl"]["constant"](10.0, 200, 512),
                       network=p["Fixed"](p["profile"].uplink_bps),
                       config=p["RC"](max_batch=1), controller=controller).run()

    tel, jtel = both(s, make)
    same_run(tel, jtel)
    assert len(tel.controller_events) <= 1


@pytest.fixture(scope="module")
def bench_cascade():
    """The serving bench's inputs: 2048 synthetic samples, T = 1 plans."""
    exits, final, y = tscn.synthetic_cascade_logits(2048)
    plan = OffloadPlan(p_tar=0.8, calibrators=[TemperatureScaling.from_temperature(1.0)] * 2)
    jplan = JPlan(p_tar=0.8, calibrators=[JTS.from_temperature(1.0)] * 2)
    core = LogitsCore(exits, final, plan, device="cpu")
    assert near_boundary(np.stack([core.conf[1], core.conf[2]]), [0.8]) == 0
    return exits, final, y, plan, jplan


@pytest.mark.parametrize("ctrl", [False, True])
def test_congested_markov_2000_requests_match_reference(bench_cascade, ctrl):
    """The bench's scenario at 2000 requests: the port's summary equals the
    reference's (BENCH_serving.json: static p99 189 988 ms and miss rate
    0.7635, controller 25 478 ms and 0.489)."""
    exits, final, y, plan, jplan = bench_cascade
    tel = tscn.run_congested_markov(plan, exits, final, y, n_requests=2000,
                                    with_controller=ctrl, device="cpu")
    jtel = jscn.run_congested_markov(jplan, exits, final, y, n_requests=2000,
                                     with_controller=ctrl)
    same_run(tel, jtel)
    with open(ROOT / "BENCH_serving.json") as f:
        bench = json.load(f)["controller" if ctrl else "static"]
    assert tel.summary()["p99_ms"] == pytest.approx(bench["p99_ms"], rel=1e-12)
    assert tel.summary()["deadline_miss_rate"] == bench["deadline_miss_rate"]


# ------------------------------------------------------------ input drift
@pytest.fixture(scope="module")
def drift():
    val, test = tscn.synthetic_distorted_cascade()
    jval, jtest = jscn.synthetic_distorted_cascade()
    for ctx in test["exit_logits"]:
        np.testing.assert_array_equal(test["features"][ctx], jtest["features"][ctx])
        np.testing.assert_array_equal(test["exit_logits"][ctx][1], jtest["exit_logits"][ctx][1])
    # the same plans in both packages: fit by the reference, carried over
    # as JSON (fits differ within hazard c, which would move decisions)
    jplans = dict(zip(("uncalibrated", "global", "bank"), jscn.fit_drift_plans(jval)))
    plans = {k: (PlanBank if k == "bank" else OffloadPlan).from_json(v.to_json())
             for k, v in jplans.items()}
    return val, test, jval, jtest, plans, jplans


DRIFT_ARMS = ["uncalibrated", "global", "bank", "controller_clean", "controller_context_aware"]


def _drift_run(scn, arm, plans, val, test, **kw):
    if arm.startswith("controller"):
        return scn.run_distortion_drift(plans["global"], test, val=val, with_controller=True,
                                        context_aware=arm.endswith("aware"),
                                        controller_config=scn.drift_controller_config(), **kw)
    return scn.run_distortion_drift(plans[arm], test, **kw)


@pytest.mark.parametrize("arm", DRIFT_ARMS)
def test_distortion_drift_matches_reference(drift, arm):
    """Equal gaps (BENCH_distortion.json: global 0.190, bank 0.021,
    controller clean 0.179 against context-aware 0.099)."""
    val, test, jval, jtest, plans, jplans = drift
    tel = _drift_run(tscn, arm, plans, val, test, device="cpu")
    jtel = _drift_run(jscn, arm, jplans, jval, jtest)
    same_run(tel, jtel)
    same_summary(tel.per_context_summary(), jtel.per_context_summary())
    with open(ROOT / "BENCH_distortion.json") as f:
        bench = json.load(f)
    key = {"global": "gap_global", "bank": "gap_bank", "controller_clean": "gap_controller_clean",
           "controller_context_aware": "gap_controller_context_aware"}.get(arm)
    if key is not None:
        assert tel.miscalibration_gap() == pytest.approx(bench[key], rel=1e-12)


def test_drift_data_keep_clear_of_the_boundary(drift):
    """The contextual cores' confidences hold no sample within 1e-6 of the
    plan's p_tar or of the controller's grid."""
    val, test, _, _, plans, _ = drift
    grid = list(tscn.drift_controller_config().p_tar_grid) + [0.8]
    sched = tscn.severity_drift_schedule()
    for key in ("uncalibrated", "global", "bank"):
        core = tscn.ContextualLogitsCore(test["exit_logits"], test["final"], plans[key], sched,
                                         labels=test["labels"],
                                         features_by_context=test["features"],
                                         backend="numpy")
        assert near_boundary(np.concatenate(list(core.conf.values())), grid) == 0


# --------------------------------------------------- engine-backed core
@pytest.fixture(scope="module")
def engine_setup():
    n = 32
    rng = np.random.default_rng(0)
    images = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, n)
    jparams = jconv.init_params(jax.random.PRNGKey(0))
    params = convnet.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return images, labels, params, jparams


@pytest.mark.parametrize("branch,level", [(1, 0), (1, 2), (2, 2)])
def test_engine_core_matches_logits_core(engine_setup, branch, level):
    """The runtime driving real partitions (EngineCore) agrees with the
    precomputed-logits core on decisions, correctness and latency; at a
    codec level the LogitsCore's cloud table is the batched cloud head on
    the round-tripped payload, priced at the codec's wire size."""
    from repro_torch.kernels.compress import roundtrip, scaled_payload_nbytes

    images, labels, params, jparams = engine_setup
    n = len(labels)
    with torch.no_grad():
        logits, payload = convnet.edge_forward(params, torch.as_tensor(images), branch=branch)
        final = convnet.cloud_forward(params, roundtrip(payload, level), from_branch=branch)
    # branch 1 at the reference's p_tar 0.5; the untrained branch 2 is less
    # confident, so it gates at its median confidence (an even count: the
    # midpoint of the middle two) to keep both outcomes
    p_tar = 0.5 if branch == 1 else float(np.median(logits.softmax(-1).amax(-1).numpy()))
    cals = [TemperatureScaling.from_temperature(1.0)] * 2
    plan = OffloadPlan(p_tar=p_tar, calibrators=cals, exit_index=branch - 1,
                       compression_level=level)
    profile = L.paper_2020()
    hook_calls = []
    engine = convnet_engine(params, plan, branch=branch, device="cpu")
    engine.timing_hook = lambda tier, dt, b: hook_calls.append((tier, b))
    ecore = EngineCore({branch: engine}, {"images": images}, labels=labels, device="cpu")
    lcore = LogitsCore({branch: logits}, final, plan.with_compression(0), labels=labels,
                       device="cpu")
    assert near_boundary(lcore.conf[branch], [p_tar]) == 0
    reqs = constant_workload(10.0, n, n)
    t_e = ServingRuntime(ecore, profile, plan, reqs, config=RuntimeConfig(max_batch=1)).run()
    t_l = ServingRuntime(lcore, profile, plan.with_compression(0), reqs,
                         config=RuntimeConfig(max_batch=1),
                         payload_nbytes=lambda b: scaled_payload_nbytes(payload_bytes(b),
                                                                        level)).run()
    e = {r.req_id: r for r in t_e.records}
    lo = {r.req_id: r for r in t_l.records}
    assert set(e) == set(lo)
    for rid in e:
        assert e[rid].on_device == lo[rid].on_device
        assert e[rid].correct == lo[rid].correct
        assert e[rid].latency_s == pytest.approx(lo[rid].latency_s, rel=1e-12)
    assert 0 < sum(r.on_device for r in e.values()) < n
    assert engine.stats.edge_calls == n and engine.stats.edge_time_s > 0
    assert ("edge", 1) in hook_calls
    # and the reference's EngineCore on the same weights at the same level:
    # the same decisions, correctness and latencies, record by record
    jplan = JPlan(p_tar=p_tar, calibrators=[JTS.from_temperature(1.0)] * 2,
                  exit_index=branch - 1, compression_level=level)
    jcore = jrt.EngineCore({branch: jengine(jparams, jplan, branch=branch)},
                           {"images": jax.numpy.asarray(images)}, labels=labels)
    t_j = jrt.ServingRuntime(jcore, JL.paper_2020(), jplan, reqs,
                             config=jrt.RuntimeConfig(max_batch=1)).run()
    j = {r.req_id: r for r in t_j.records}
    assert set(j) == set(e)
    for rid in e:
        assert (e[rid].on_device, e[rid].correct) == (j[rid].on_device, j[rid].correct)
        assert e[rid].latency_s == pytest.approx(j[rid].latency_s, rel=1e-12)
