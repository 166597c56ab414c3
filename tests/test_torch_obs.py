"""Port parity for the observability plane (`repro_torch.obs`) on the
CPU: the serving cases of tests/test_obs.py and
tests/test_calibration_obs.py, run on the port, plus the same run through
both packages compared artifact for artifact.

Tolerances:
* obs-on against obs-off summaries: equal (zero perturbation, bit-exact);
* trace records, audit records, metrics JSON and the Prometheus text of
  the same run against the reference's: every value equal, line for line,
  except the numbers computed from gate confidences (the record's
  confidence, the ECE and Brier gauges, the confidence histogram's sum),
  which agree to the gate tolerance rel 2e-5 / abs 1e-6: the two
  packages' float32 softmaxes differ by an ulp or two; the sketch's
  count rows are equal bin for bin;
* the sketch's ECE against `repro_torch.core.metrics.ece`: 1e-12 on
  closed forms, 1e-9 against a trace (the reference's check);
* `repro_torch.obs.check` finds no violation on the port's artifacts.
The fleet and orchestration cases are in tests/test_torch_fleet.py; the
compiled-fleet ones wait for that module.
"""
import copy
import json
import re

import numpy as np
import pytest

from repro.core.calibration import TemperatureScaling as JTS
from repro.core.policy import OffloadPlan as JPlan
from repro.obs import MetricsRegistry as JMetrics
from repro.obs import ReliabilitySketch as JSketch
from repro.obs import build_spans as jbuild_spans
from repro.obs import full_observability as jfull
from repro.obs.calibration_report import build_report as jbuild_report
from repro.serving import scenarios as jscn
from repro_torch.core.bank import PlanBank
from repro_torch.core.calibration import TemperatureScaling
from repro_torch.core.metrics import ece as core_ece
from repro_torch.core.policy import OffloadPlan
from repro_torch.obs import (
    AuditLog,
    JsonlTraceSink,
    MetricsRegistry,
    Observability,
    ReliabilitySketch,
    RingBufferSink,
    build_spans,
    full_observability,
    read_jsonl,
    request_record,
)
from repro_torch.obs.calibration import (
    GLOBAL_CONTEXT,
    bin_edges,
    bin_index,
    block_reliability,
    merge_sketches,
)
from repro_torch.obs.calibration_report import build_report
from repro_torch.obs.calibration_report import main as report_main
from repro_torch.obs.check import (
    check_calibration,
    check_gate_consistency,
    check_span_telescoping,
    run_checks,
)
from repro_torch.obs.check import main as check_main
from repro_torch.serving import scenarios as tscn


def serving_setup():
    exits, final, y = tscn.synthetic_cascade_logits(512)
    plan = OffloadPlan(p_tar=0.8, calibrators=[TemperatureScaling.from_temperature(1.0)] * 2)
    jplan = JPlan(p_tar=0.8, calibrators=[JTS.from_temperature(1.0)] * 2)
    return plan, jplan, exits, final, y


@pytest.fixture(scope="module")
def serving_obs():
    """One congested run with the controller and every sink, through the
    port and through the reference."""
    plan, jplan, exits, final, y = serving_setup()
    obs, jobs = full_observability(), jfull()
    tel = tscn.run_congested_markov(plan, exits, final, y, n_requests=400, with_controller=True,
                                    obs=obs, device="cpu")
    jtel = jscn.run_congested_markov(jplan, exits, final, y, n_requests=400,
                                     with_controller=True, obs=jobs)
    return tel, obs, jtel, jobs


@pytest.fixture(scope="module")
def drift_data():
    """The obs tests' drift scenario (blur drifts under-confident): data
    from the port's generator, plans fit by the reference and carried
    over as JSON, so both packages serve the same plans."""
    val, test = tscn.synthetic_distorted_cascade(directions={"gaussian_blur": "under"})
    uncal, glob, bank = jscn.fit_drift_plans(val)
    return val, test, PlanBank.from_json(bank.to_json()), bank


# ------------------------------------------------------------------ sinks
def test_ring_buffer_sink_caps_but_counts():
    sink = RingBufferSink(capacity=3)
    for i in range(5):
        sink.emit({"kind": "request", "req_id": i})
    assert sink.emitted == 5 and len(sink) == 3
    assert [r["req_id"] for r in sink.records] == [2, 3, 4]


def test_jsonl_sink_roundtrip(tmp_path):
    from repro.obs import read_jsonl as jread_jsonl

    path = str(tmp_path / "trace.jsonl")
    sink = JsonlTraceSink(path)
    sink.emit({"kind": "request", "req_id": 0, "latency_s": 0.01})
    sink.emit({"kind": "request", "req_id": 1, "latency_s": 0.02})
    sink.close()
    back = read_jsonl(path)
    assert [r["req_id"] for r in back] == [0, 1] and back[1]["latency_s"] == 0.02
    assert jread_jsonl(path) == back


# ------------------------------------------------------------ span grammar
def test_build_spans_on_device_and_offloaded():
    on = build_spans(1.0, 1.2, 1.5)
    assert [s["name"] for s in on] == ["queue_edge", "edge"]
    args = (1.0, 1.2, 1.5)
    kw = dict(uplink_start_s=1.6, uplink_done_s=1.9, cloud_start_s=2.0, complete_s=2.4)
    off = build_spans(*args, **kw)
    assert off == jbuild_spans(*args, **kw) and on == jbuild_spans(*args)
    assert [s["name"] for s in off] == ["queue_edge", "edge", "queue_uplink", "uplink",
                                        "queue_cloud", "cloud"]
    assert check_span_telescoping([request_record("test", 0, 1.0, 2.4, False, off)]) == []
    instant = build_spans(1.0, 1.0, 1.5)
    assert instant[0]["start_s"] == instant[0]["end_s"] == 1.0


def test_telescoping_check_catches_gaps():
    spans = build_spans(1.0, 1.2, 1.5)
    spans[1]["end_s"] += 0.5
    errs = check_span_telescoping([request_record("test", 7, 1.0, 1.5, True, spans)])
    assert errs and "req 7" in errs[0]


def test_gate_consistency_check():
    on = request_record("test", 0, 0.0, 1.0, True, build_spans(0.0, 0.0, 1.0),
                        gate={"confidence": 0.9, "p_tar": 0.8, "criterion": "confidence"})
    assert check_gate_consistency([on]) == []
    bad = request_record("test", 1, 0.0, 1.0, True, build_spans(0.0, 0.0, 1.0),
                         gate={"confidence": 0.5, "p_tar": 0.8, "criterion": "confidence"})
    assert check_gate_consistency([bad])
    lie = request_record("test", 2, 0.0, 2.0, True,
                         build_spans(0.0, 0.0, 1.0, uplink_start_s=1.0, uplink_done_s=1.5,
                                     cloud_start_s=1.5, complete_s=2.0))
    assert check_gate_consistency([lie])
    assert check_gate_consistency([request_record(
        "test", 3, 0.0, 1.0, True, build_spans(0.0, 0.0, 1.0))]) == []


# ---------------------------------------------------------------- metrics
def _fill(m):
    m.inc("reqs_total", 3, cell=0)
    m.inc("reqs_total", 2, cell=1)
    m.inc("reqs_total", cell=0)
    m.set_gauge("rate", 0.25, source="fleet")
    m.declare_histogram("lat_ms", (1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        m.observe("lat_ms", v)
    m.observe_counts("lat_ms", [1, 0, 2, 1], 123.5, cell=2)
    return m


def test_metrics_registry_counters_gauges_histograms():
    m = _fill(MetricsRegistry())
    assert m.counter_total("reqs_total") == 6
    assert m.counter_total("reqs_total", cell=0) == 4
    with pytest.raises(ValueError):
        m.inc("reqs_total", -1)
    assert m.gauge_value("rate", source="fleet") == 0.25
    assert m.gauge_value("rate", source="nope") is None
    with pytest.raises(ValueError):
        m.declare_histogram("lat_ms", (5.0,))
    back = MetricsRegistry.from_json(json.loads(json.dumps(m.to_json())))
    assert back.counter_total("reqs_total", cell=0) == 4
    assert back.gauge_value("rate", source="fleet") == 0.25
    # the reference reads the port's JSON back to the same registry
    assert JMetrics.from_json(m.to_json()).to_json() == m.to_json()


def test_metrics_prometheus_exposition():
    m = MetricsRegistry()
    m.inc("reqs_total", 2, cell=3)
    m.set_gauge("up", 1.0)
    m.declare_histogram("lat_ms", (10.0, 100.0))
    m.observe("lat_ms", 5.0)
    m.observe("lat_ms", 50.0)
    text = m.to_prometheus()
    assert "# TYPE reqs_total counter" in text and 'reqs_total{cell="3"} 2' in text
    assert "# TYPE lat_ms histogram" in text
    assert 'lat_ms_bucket{le="10"} 1' in text and 'lat_ms_bucket{le="100"} 2' in text
    assert 'lat_ms_bucket{le="+Inf"} 2' in text and "lat_ms_count 2" in text
    assert _fill(MetricsRegistry()).to_prometheus() == _fill(JMetrics()).to_prometheus()


# --------------------------------------------------- zero-perturbation
@pytest.mark.parametrize("ctrl", [False, True])
def test_serving_obs_is_bit_exact_congested(ctrl):
    """Attaching the full bundle moves no simulated number, and both runs
    are the reference's."""
    plan, jplan, exits, final, y = serving_setup()
    bare = tscn.run_congested_markov(plan, exits, final, y, n_requests=300,
                                     with_controller=ctrl, device="cpu").summary()
    obs = full_observability()
    wired = tscn.run_congested_markov(plan, exits, final, y, n_requests=300,
                                      with_controller=ctrl, device="cpu", obs=obs).summary()
    assert json.dumps(bare) == json.dumps(wired)
    assert len(obs.trace) == 300
    ref = jscn.run_congested_markov(jplan, exits, final, y, n_requests=300,
                                    with_controller=ctrl).summary()
    assert json.dumps(bare) == json.dumps(ref)


def test_serving_obs_is_bit_exact(drift_data):
    val, test, bank, _ = drift_data
    bare = tscn.run_distortion_drift(bank, test, val=val, with_controller=True, n_requests=250,
                                     device="cpu").summary()
    obs = full_observability()
    wired = tscn.run_distortion_drift(bank, test, val=val, with_controller=True, n_requests=250,
                                      obs=obs, device="cpu").summary()
    assert json.dumps(bare) == json.dumps(wired)
    assert len(obs.trace) == 250


# -------------------------------------------------- end-to-end invariants
def test_serving_trace_invariants_and_audit(serving_obs):
    tel, obs, _, _ = serving_obs
    recs = obs.trace.records
    assert run_checks(recs, obs.metrics, obs.audit.records) == []
    assert len(recs) == 400
    offloaded = [r for r in recs if not r["on_device"]]
    assert offloaded and all([s["name"] for s in r["spans"]][-1] == "cloud" for r in offloaded)
    rescored = obs.audit.filter(action="controller_rescore")
    assert rescored and all(
        r["actor"] == "online_controller"
        and {"bandwidth_bps", "held", "chosen"} <= set(r["evidence"]) for r in rescored)
    s = tel.summary()
    assert obs.metrics.counter_total("serving_requests_total") == s["requests"]
    assert obs.metrics.counter_total("serving_requests_total", path="cloud") == \
        pytest.approx(s["offload_rate"] * s["requests"], abs=0.5)


#: the families whose numbers carry gate confidences; everything else in
#: the registry counts decisions or times and must be equal
CONF_FAMILIES = ("calibration_ece", "calibration_brier", "calibration_confidence_sum")
CONF_TOL = dict(rel=2e-5, abs=1e-6)


def _same_conf_fields(a, b):
    """Two trace records: equal, except the gate confidence, which agrees
    to the gate tolerance (the two packages' float32 softmaxes differ by
    an ulp or two)."""
    a, b = copy.deepcopy(a), copy.deepcopy(b)
    ca, cb = a["gate"].pop("confidence"), b["gate"].pop("confidence")
    assert ca == pytest.approx(cb, **CONF_TOL)
    return a == b


@pytest.mark.parametrize("artifact", ["trace", "audit", "metrics_json", "prometheus", "sketch"])
def test_serving_artifacts_equal_reference(serving_obs, artifact):
    """The same run through both packages writes the same artifacts:
    trace and audit records, metrics JSON, the Prometheus text line for
    line, and the calibration sketch bin for bin. Numbers computed from
    gate confidences agree to the gate tolerance; every other value is
    equal."""
    _, obs, _, jobs = serving_obs
    if artifact == "trace":
        recs, jrecs = obs.trace.records, jobs.trace.records
        assert len(recs) == len(jrecs) == 400
        assert all(_same_conf_fields(a, b) for a, b in zip(recs, jrecs))
    elif artifact == "audit":
        assert len(obs.audit) == len(jobs.audit) > 0
        assert all(json.dumps(a) == json.dumps(b)
                   for a, b in zip(obs.audit.records, jobs.audit.records))
    elif artifact == "metrics_json":
        got, want = obs.metrics.to_json(), jobs.metrics.to_json()
        assert got["counters"] == want["counters"]
        assert got["histograms"]["serving_latency_ms"] == want["histograms"]["serving_latency_ms"]
        for name in set(got["gauges"]) | set(want["gauges"]):
            rows, jrows = got["gauges"][name], want["gauges"][name]
            assert [r["labels"] for r in rows] == [r["labels"] for r in jrows]
            tol = CONF_TOL if name in CONF_FAMILIES else dict(rel=0, abs=0)
            assert [r["value"] for r in rows] == pytest.approx([r["value"] for r in jrows], **tol)
    elif artifact == "prometheus":
        lines, jlines = obs.metrics.to_prometheus().splitlines(), \
            jobs.metrics.to_prometheus().splitlines()
        assert any(x.startswith("serving_latency_ms_bucket") for x in lines)
        assert len(lines) == len(jlines)
        differ = [(a, b) for a, b in zip(lines, jlines) if a != b]
        for a, b in differ:  # only confidence-carrying samples may differ
            (name, va), (jname, vb) = a.rsplit(" ", 1), b.rsplit(" ", 1)
            assert name == jname and name.split("{")[0] in CONF_FAMILIES, (a, b)
            assert float(va) == pytest.approx(float(vb), **CONF_TOL)
    else:
        assert obs.calibration.keys() == jobs.calibration.keys()
        for key in obs.calibration.keys():
            a, b = obs.calibration.block(*key), jobs.calibration.block(*key)
            np.testing.assert_array_equal(a[[0, 1, 5, 6]], b[[0, 1, 5, 6]])
            np.testing.assert_allclose(a[2:5], b[2:5], rtol=2e-5, atol=1e-6 * a[0].sum())
        assert obs.calibration.ece() == pytest.approx(jobs.calibration.ece(), **CONF_TOL)


def test_check_cli_on_port_artifacts(tmp_path, serving_obs):
    """`python -m repro_torch.obs.check` passes on the JSONL trace, metrics
    JSON and audit JSONL the port writes, and fails a corrupted trace."""
    plan, _, exits, final, y = serving_setup()
    tpath, mpath, apath = (str(tmp_path / n) for n in ("trace.jsonl", "metrics.json",
                                                       "audit.jsonl"))
    metrics, audit = MetricsRegistry(), AuditLog()
    obs = Observability(trace=JsonlTraceSink(tpath), metrics=metrics, audit=audit)
    tscn.run_congested_markov(plan, exits, final, y, n_requests=200, with_controller=True,
                              obs=obs, device="cpu")
    obs.close()
    metrics.write_json(mpath)
    audit.to_jsonl(apath)
    assert len(AuditLog.read_jsonl(apath)) == len(audit) > 0
    assert check_main(["--trace", tpath, "--metrics", mpath, "--audit", apath]) == 0
    recs = read_jsonl(tpath)
    recs[0]["latency_s"] += 1.0
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    assert check_main(["--trace", bad]) == 1


def test_check_fails_on_corrupted_serving_artifacts(serving_obs):
    _, obs, _, _ = serving_obs
    recs = copy.deepcopy(obs.trace.records)
    recs[5]["spans"][-1]["end_s"] += 0.25
    errs = run_checks(recs)
    assert errs and any(f"req {recs[5]['req_id']}" in e for e in errs)
    errs = run_checks(obs.trace.records[1:], obs.metrics)
    assert errs and any("trace" in e and "records" in e for e in errs)
    forged = copy.deepcopy(obs.calibration)
    warped = forged.block(*forged.keys()[0])
    warped[2] *= 1.5
    errs = check_calibration(forged, trace_records=obs.trace.records)
    assert errs and "ECE" in errs[0]


# ------------------------------------------------------------ sketch unit
def _synthetic_stream(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0.05, 1.0, n)
    correct = rng.random(n) < conf ** 1.7
    return conf, correct.astype(bool), conf >= 0.8


def test_bin_edges_and_boundary_assignment():
    edges = bin_edges(15)
    assert len(edges) == 16 and edges[0] == 0.0 and edges[-1] == 1.0
    idx = bin_index(np.array([0.0, 1e-12, edges[1], 0.5, 1.0]))
    assert idx[0] == 15 and idx[1] == 0 and idx[2] == 0 and idx[4] == 14


def test_sketch_merge_is_exact_sum():
    conf, correct, on = _synthetic_stream()
    full = ReliabilitySketch()
    full.update(0, "clean", 1, conf, correct, on)
    full.note_ungated(0, 7)
    a, b = ReliabilitySketch(), ReliabilitySketch()
    a.update(0, "clean", 1, conf[:2000], correct[:2000], on[:2000])
    b.update(0, "clean", 1, conf[2000:], correct[2000:], on[2000:])
    b.note_ungated(0, 7)
    merged = merge_sketches([a, b])
    assert merged.keys() == full.keys()
    for key in full.keys():
        x, z = full.block(*key), merged.block(*key)
        np.testing.assert_array_equal(z[[0, 1, 5, 6]], x[[0, 1, 5, 6]])
        np.testing.assert_allclose(z[2:5], x[2:5], rtol=0, atol=1e-9)
    assert merged.ungated_count(0) == 7
    assert merged.total_count() == full.total_count() == 4007
    with pytest.raises(ValueError):
        full.merge(ReliabilitySketch(n_bins=7))


def test_sketch_statistics_match_closed_forms():
    conf, correct, on = _synthetic_stream()
    sk = ReliabilitySketch()
    sk.update(3, GLOBAL_CONTEXT, 2, conf, correct, on)
    jsk = JSketch()
    jsk.update(3, GLOBAL_CONTEXT, 2, conf, correct, on)
    np.testing.assert_array_equal(sk.block(3, GLOBAL_CONTEXT, 2), jsk.block(3, GLOBAL_CONTEXT, 2))
    assert sk.ece() == pytest.approx(float(core_ece(conf, correct)), abs=1e-12)
    assert sk.brier() == pytest.approx(float(np.mean((conf - correct) ** 2)), abs=1e-12)
    assert sk.coverage() == pytest.approx(float(correct[on].mean()), abs=1e-12)
    bins = sk.reliability()
    assert sum(b["count"] for b in bins) == len(conf)
    for b in bins:
        assert b["residual"] == pytest.approx(b["mean_conf"] - b["accuracy"], abs=1e-12)


def test_sketch_json_roundtrip(tmp_path):
    conf, correct, on = _synthetic_stream(n=500)
    sk = ReliabilitySketch()
    sk.update(0, "clean", 1, conf, correct, on)
    sk.update(2, "contrast@4", 2, conf[:100], correct[:100], on[:100])
    sk.note_ungated(2, 13)
    path = str(tmp_path / "sketch.json")
    sk.save(path)
    for back in (ReliabilitySketch.load(path), JSketch.load(path)):
        assert back.n_bins == sk.n_bins and back.keys() == sk.keys()
        for key in sk.keys():
            assert np.array_equal(back.block(*key), sk.block(*key))
        assert back.ungated_count() == 13
    with pytest.raises(ValueError):
        sk.update_binned(0, "clean", 1, np.zeros((7, 3)))


def test_serving_sketch_reproduces_trace_ece(serving_obs):
    """The runtime's sketch reproduces `core.metrics.ece` from the raw
    unsampled trace: gate records carry the EDGE prediction's correctness
    captured at gate time, offloaded requests included."""
    _, obs, _, _ = serving_obs
    recs = obs.trace.records
    assert run_checks(recs, obs.metrics, obs.audit.records, calibration=obs.calibration) == []
    gates = [r["gate"] for r in recs if r["gate"] is not None]
    assert gates and all(g["correct"] in (0, 1) for g in gates)
    conf = np.array([g["confidence"] for g in gates])
    cor = np.array([g["correct"] for g in gates], bool)
    assert obs.calibration.ece() == pytest.approx(float(core_ece(conf, cor)), abs=1e-9)
    assert obs.calibration.gated_count() == len(gates) == 400
    assert obs.metrics.gauge_value("calibration_ece") is not None
    assert obs.metrics.gauge_value("calibration_gated_total", cell=0) == 400


# ------------------------------------ Prometheus exposition conformance
def _parse_prometheus(text):
    """Minimal 0.0.4 parser: {name: {type, help, samples}} with samples
    (sample_name, labels, value)."""
    families = {}
    label_re = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            name, help_text = line[len("# HELP "):].split(" ", 1)
            fam = families.setdefault(name, {"type": None, "help": None, "samples": []})
            fam["help"] = help_text.replace("\\n", "\n").replace("\\\\", "\\")
        elif line.startswith("# TYPE "):
            name, kind = line[len("# TYPE "):].split(" ", 1)
            families.setdefault(name, {"type": None, "help": None, "samples": []})["type"] = kind
        else:
            sample_name, rest = re.match(r"([\w:]+)(.*)", line).groups()
            labels = {}
            if rest.startswith("{"):
                body, rest = rest[1:].split("}", 1)
                for k, v in label_re.findall(body):
                    labels[k] = v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
            fam = sample_name
            for suffix in ("_bucket", "_sum", "_count"):
                if fam.endswith(suffix) and fam[:-len(suffix)] in families:
                    fam = fam[:-len(suffix)]
                    break
            families[fam]["samples"].append((sample_name, labels, float(rest.strip())))
    return families


def _assert_conformant(m):
    families = _parse_prometheus(m.to_prometheus())
    for name, fam in families.items():
        assert fam["type"] in ("counter", "gauge", "histogram") and fam["help"], name
        assert fam["samples"], name
        if fam["type"] != "histogram":
            continue
        series = {}
        for sname, labels, value in fam["samples"]:
            rest = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
            series.setdefault(rest, {})[(sname, labels.get("le"))] = value
        for rest, samples in series.items():
            les = [(le, v) for (sn, le), v in samples.items() if sn == f"{name}_bucket"]
            finite = [(float(le), v) for le, v in les if le != "+Inf"]
            assert sorted(x for x, _ in finite) == [x for x, _ in finite]
            cum = [v for _, v in sorted(finite)]
            assert cum == sorted(cum)
            inf = [v for le, v in les if le == "+Inf"]
            assert len(inf) == 1 and (not finite or inf[0] >= cum[-1])
            assert samples[(f"{name}_count", None)] == inf[0]
    return families


def test_prometheus_conformance_on_serving_artifacts(serving_obs):
    tel, obs, _, _ = serving_obs
    families = _assert_conformant(obs.metrics)
    assert families["calibration_confidence"]["type"] == "histogram"
    assert families["serving_latency_ms"]["type"] == "histogram"
    total = sum(v for _, _, v in families["serving_requests_total"]["samples"])
    assert total == obs.metrics.counter_total("serving_requests_total") == len(tel.records)


def test_prometheus_label_escaping_roundtrip():
    m = MetricsRegistry()
    nasty = 'quote " backslash \\ newline \n done'
    m.set_gauge("escape_check", 1.5, ctx=nasty)
    m.describe("escape_check", "help with \\ and\nnewline")
    text = m.to_prometheus()
    assert '\\"' in text and "\\n" in text and "\n done" not in text
    (_, labels, value), = _parse_prometheus(text)["escape_check"]["samples"]
    assert labels["ctx"] == nasty and value == 1.5
    assert _parse_prometheus(text)["escape_check"]["help"] == "help with \\ and\nnewline"
    j = JMetrics()
    j.set_gauge("escape_check", 1.5, ctx=nasty)
    j.describe("escape_check", "help with \\ and\nnewline")
    assert text == j.to_prometheus()


def test_prometheus_histogram_le_ordering_unit():
    m = MetricsRegistry()
    m.declare_histogram("order_check", (0.5, 1.0, 2.0, 4.0))
    for v in (0.1, 0.7, 1.5, 3.0, 9.0):
        m.observe("order_check", v, cell=0)
    fam = _assert_conformant(m)["order_check"]
    buckets = [(labels["le"], v) for sname, labels, v in fam["samples"]
               if sname == "order_check_bucket"]
    assert [b[0] for b in buckets] == ["0.5", "1", "2", "4", "+Inf"]
    assert [b[1] for b in buckets] == [1, 2, 3, 4, 5]


# ----------------------------------------------------- drift report + CLI
def test_build_report_flags_only_drifted_regimes():
    rng = np.random.default_rng(1)
    sk, jsk = ReliabilitySketch(), JSketch()
    conf = rng.uniform(0.3, 1.0, 3000)
    c1, c2 = rng.random(3000) < conf, rng.random(3000) < conf - 0.25
    for s in (sk, jsk):
        s.update(0, "clean", 1, conf, c1, conf >= 0.8)
        s.update(0, "contrast@4", 1, conf, c2, conf >= 0.8)
    bank_meta = {"fit_ece": {"clean": {"1": sk.ece(context="clean")},
                             "contrast@4": {"1": 0.01}}, "default_context": "clean"}
    report = build_report(sk, bank_meta=bank_meta, drift_cap=0.05)
    assert report["flagged"] and report["flags"] and "contrast@4" in report["flags"][0]
    assert not report["regimes"]["clean"]["drifted"]
    assert report["regimes"]["contrast@4"]["drifted"]
    assert report["regimes"]["clean"]["bins"] == block_reliability(sk.merged_block(context="clean"))
    assert json.dumps(report, sort_keys=True) == json.dumps(
        jbuild_report(jsk, bank_meta=bank_meta, drift_cap=0.05), sort_keys=True)
    bare = build_report(sk, drift_cap=0.05)
    assert not bare["flagged"] and bare["regimes"]["contrast@4"]["fit_ece"] is None


def test_report_resolves_global_context_to_default():
    rng = np.random.default_rng(2)
    sk = ReliabilitySketch()
    conf = rng.uniform(0.3, 1.0, 2000)
    sk.update(0, GLOBAL_CONTEXT, 1, conf, rng.random(2000) < conf - 0.3, conf >= 0.8)
    report = build_report(sk, bank_meta={"fit_ece": {"clean": {"1": 0.02}},
                                         "default_context": "clean"})
    reg = report["regimes"][GLOBAL_CONTEXT]
    assert reg["fit_ece"] == 0.02 and reg["drifted"]


def test_calibration_report_cli(tmp_path, drift_data):
    """Exit code 1 == drift found; sketches merge; the port's bank JSON
    (the reference's fit, carried over) supplies the fit-time ECE."""
    _, _, bank, _ = drift_data
    bank_path = str(tmp_path / "bank.json")
    bank.save(bank_path)
    rng = np.random.default_rng(3)
    conf = rng.uniform(0.3, 1.0, 2000)
    a, b = ReliabilitySketch(), ReliabilitySketch()
    ctx = bank.default_context
    a.update(0, ctx, 1, conf[:1000], rng.random(1000) < conf[:1000] - 0.3, conf[:1000] >= 0.8)
    b.update(0, ctx, 1, conf[1000:], rng.random(1000) < conf[1000:] - 0.3, conf[1000:] >= 0.8)
    pa, pb = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    a.save(pa)
    b.save(pb)
    out = str(tmp_path / "report.json")
    assert report_main(["--sketch", pa, pb, "--bank", bank_path, "--out", out]) == 1
    with open(out) as f:
        report = json.load(f)
    assert report["flagged"] and report["regimes"][ctx]["drifted"]
    assert report["regimes"][ctx]["count"] == 2000
    good = ReliabilitySketch()
    good.update(0, ctx, 1, conf, rng.random(2000) < conf, conf >= 0.8)
    pg = str(tmp_path / "good.json")
    good.save(pg)
    cap = abs(good.ece() - bank.metadata["fit_ece"][ctx]["1"]) + 0.05
    assert report_main(["--sketch", pg, "--bank", bank_path, "--drift-cap", str(cap)]) == 0
