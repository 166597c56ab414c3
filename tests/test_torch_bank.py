"""Port parity for the distortion workload, the plan bank, the gate
backends and the controller core (`repro_torch.data.distortion`,
`repro_torch.core.{bank,gatepath,control}`) against the reference on the
CPU. Data: the reference's seeded drift scenario (per-context cascade
logits with features of really distorted `cifar_like` images).

Tolerances:
* distortions and input features: bit-equal (the same numpy code);
* fitted expert temperatures: rtol 2e-4 (the reference fit is only
  determined to about 2e-4, ROADMAP hazard c); estimator verdicts equal;
  the frozen fit-time ECE to 1e-6 of the reference's ECE at the port's
  temperatures (to 1e-4 of the reference's own, whose temperatures differ
  within hazard c);
* gate confidences rtol 2e-5 / atol 1e-6, predictions equal, decisions
  equal away from p_tar +- 1e-6 (K1's boundary, hazard d; the data are
  checked to keep clear of it);
* window tables and per-cell counts: equal;
* rescore_plan tables: the same rows in the same order, numbers to 1e-6,
  the same winner.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bank as jbank
from repro.core import control as jcontrol
from repro.core import exits as jexits
from repro.core import metrics as jmetrics
from repro.core import gatepath as jgate
from repro.core.calibration import TemperatureScaling as JTS
from repro.core.calibration import get_calibrator as jget_calibrator
from repro.core.policy import OffloadPlan as JPlan
from repro.data import distortion as jdist
from repro.data.synthetic import ImageSplits as JSplits
from repro.offload import latency as jlat
from repro.serving.scenarios import synthetic_distorted_cascade
from repro_torch.core import bank as tbank
from repro_torch.core import control as tcontrol
from repro_torch.core import gatepath as tgate
from repro_torch.core.calibration import CalibratorState
from repro_torch.core.calibration import TemperatureScaling as TTS
from repro_torch.core.calibration import get_calibrator as tget_calibrator
from repro_torch.core.policy import OffloadPlan as TPlan
from repro_torch.data import distortion as tdist
from repro_torch.data.synthetic import ImageSplits as TSplits
from repro_torch.offload import latency as tlat

CONF_TOL = dict(rtol=2e-5, atol=1e-6)
P_TAR = 0.8
TORCH_CPU = tgate.TorchGateBackend(device="cpu")


@pytest.fixture(scope="module")
def drift():
    val, test = synthetic_distorted_cascade(n=300, n_val=300)
    exits = {c: [z[1], z[2]] for c, z in val["exit_logits"].items()}
    j = jbank.fit_bank(exits, val["labels"], p_tar=P_TAR, features_by_context=val["features"])
    t = tbank.fit_bank(exits, val["labels"], p_tar=P_TAR, features_by_context=val["features"],
                       device="cpu")
    return val, test, j, t


def _clear_of(conf, p_tars):
    for p in np.atleast_1d(p_tars):
        assert np.abs(np.asarray(conf, np.float64) - p).min() > 1e-6, \
            "a confidence sits on K1's boundary"


def _same_gate(got, want, p_tars=(P_TAR,)):
    (tc, tp), (jc, jp) = got[:2], want[:2]
    np.testing.assert_allclose(tc, np.asarray(jc), **CONF_TOL)
    np.testing.assert_array_equal(tp, np.asarray(jp))
    _clear_of(jc, p_tars)
    for p in p_tars:
        np.testing.assert_array_equal(tc >= p, np.asarray(jc) >= p)


# ------------------------------------------------------------ distortion
@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).standard_normal((6, 32, 32, 3)).astype(np.float32) * 2 + 1


@pytest.mark.parametrize("kind", jdist.DISTORTION_KINDS)
def test_apply_distortion_is_bit_equal(images, kind):
    severities = [0] if kind == "clean" else range(1, jdist.MAX_SEVERITY + 1)
    for s in severities:
        got = tdist.apply_distortion(images, tdist.DistortionSpec(kind, s), seed=5)
        want = jdist.apply_distortion(images, jdist.DistortionSpec(kind, s), seed=5)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tdist.input_features(got), jdist.input_features(want))


def test_distort_splits_and_contexts_match_reference(images):
    y = np.arange(6, dtype=np.int32)
    spec = ("gaussian_noise", 2)
    got = tdist.distort_splits(TSplits(images, y, images[:3], y[:3], images[3:], y[3:]),
                               tdist.DistortionSpec(*spec), seed=4)
    want = jdist.distort_splits(JSplits(images, y, images[:3], y[:3], images[3:], y[3:]),
                                jdist.DistortionSpec(*spec), seed=4)
    for name in ("train_x", "train_y", "val_x", "val_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert ([s.key for s in tdist.default_contexts()]
            == [s.key for s in jdist.default_contexts()])
    assert tdist.FEATURE_NAMES == jdist.FEATURE_NAMES
    assert tdist.DistortionSpec.parse("box_blur@4") == tdist.DistortionSpec("box_blur", 4)
    with pytest.raises(ValueError, match="severity"):
        tdist.DistortionSpec("contrast", 6)


# -------------------------------------------------------------- fit_bank
def test_fit_bank_matches_reference(drift):
    val, test, j, t = drift
    assert t.contexts == j.contexts and t.default_context == j.default_context
    for ctx in j.contexts:
        np.testing.assert_allclose(t.plans[ctx].temperatures, j.plans[ctx].temperatures,
                                   rtol=2e-4, err_msg=ctx)
        for bi, z in enumerate(val["exit_logits"][ctx].values()):
            br = str(bi + 1)
            np.testing.assert_allclose(t.metadata["fit_ece"][ctx][br],
                                       j.metadata["fit_ece"][ctx][br], atol=1e-4)
            conf, pred, _ = jexits.gate_statistics(jnp.asarray(z), t.plans[ctx].temperatures[bi])
            want = jmetrics.ece(np.asarray(conf, np.float64),
                                (np.asarray(pred) == val["labels"]).astype(np.float64))
            np.testing.assert_allclose(t.metadata["fit_ece"][ctx][br], want, atol=1e-6)
    for field in ("centroids", "norm_mean", "norm_std"):
        np.testing.assert_array_equal(getattr(t.estimator, field), getattr(j.estimator, field))
    assert t.estimator.feature_names == j.estimator.feature_names
    for ctx, f in test["features"].items():
        np.testing.assert_array_equal(t.estimator.predict_ids(f), j.estimator.predict_ids(f))
        assert t.estimator.predict(f) == j.estimator.predict(f)


def test_plan_bank_json_loads_across_packages_and_gates_identically(drift):
    val, test, j, t = drift
    j_text = j.to_json()
    t_loaded = tbank.PlanBank.from_json(j_text)
    assert t_loaded.to_json() == j_text
    t_text = t.bumped().to_json()
    j_loaded = jbank.PlanBank.from_json(t_text)
    assert j_loaded.to_json() == t_text and j_loaded.bank_version == 1
    for ctx in test["exit_logits"]:
        z, f = test["exit_logits"][ctx][1], test["features"][ctx]
        want = j.gate_block(z, features=f, branch=0)
        for backend in ("numpy", TORCH_CPU):
            got = t_loaded.gate_block(z, features=f, branch=0, backend=backend)
            np.testing.assert_array_equal(got[2], want[2])
            _same_gate(got, want)


def test_plan_json_loads_across_packages_and_gates_identically(drift):
    val, test, j, _ = drift
    plan = j.plan_for("contrast@4").with_compression(2)
    t_plan = TPlan.from_json(plan.to_json())
    assert t_plan.to_json() == plan.to_json()
    z = test["exit_logits"]["contrast@4"][2]
    _same_gate(t_plan.gate_block(z, branch=1, backend=TORCH_CPU), plan.gate_block(z, branch=1))


# ------------------------------------------------------------ gatepath
def test_backend_registry_and_device_rule():
    assert {"numpy", "torch", "compiled"} <= set(tgate.available_gate_backends())
    assert isinstance(tgate.get_gate_backend(None), tgate.TorchGateBackend)
    assert tgate.get_gate_backend(TORCH_CPU) is TORCH_CPU
    assert TORCH_CPU.device == torch.device("cpu")
    assert tgate.get_gate_backend("numpy").device == torch.device("cpu")
    compiled = tgate.get_gate_backend("compiled")
    assert isinstance(compiled, tgate.TorchGateBackend) and compiled.name == "compiled"
    with pytest.raises(ValueError, match="unknown gate backend"):
        tgate.get_gate_backend("jax")


@pytest.mark.parametrize("kind", ["temperature", "identity", "vector"])
def test_plan_gate_block_backends_match_reference(drift, kind):
    val, test, _, _ = drift
    z, y = test["exit_logits"]["gaussian_blur@3"][1], test["labels"]
    if kind == "vector":
        vz = val["exit_logits"]["gaussian_blur@3"][1]
        jstate = jget_calibrator("vector").fit(jnp.asarray(vz), jnp.asarray(val["labels"]))
        tstate = CalibratorState.from_dict(jstate.to_dict())
        jplan = JPlan(p_tar=P_TAR, calibrators=[jstate])
        tplan = TPlan(p_tar=P_TAR, calibrators=[tstate])
    else:
        jplan = JPlan(p_tar=P_TAR, calibrators=[JTS.from_temperature(1.9)])
        tplan = TPlan(p_tar=P_TAR, calibrators=[TTS.from_temperature(1.9)])
        if kind == "identity":
            jplan = JPlan(p_tar=P_TAR, calibrators=[jget_calibrator("identity").fit(z, y)])
            tplan = TPlan(p_tar=P_TAR, calibrators=[tget_calibrator("identity").fit(z, y)])
    for jb in ("numpy", "jax"):
        want = jgate.get_gate_backend(jb).plan_gate_block(jplan, z, branch=0)
        for tb in ("numpy", TORCH_CPU):
            _same_gate(tgate.get_gate_backend(tb).plan_gate_block(tplan, z, branch=0), want)


def test_bank_gate_block_backends_match_reference(drift):
    _, test, j, t = drift
    ctx = "gaussian_noise@2"
    z = test["exit_logits"][ctx][2]
    ids = j.estimator.predict_ids(test["features"][ctx])
    ids[::7] = -1  # unknown verdicts -> the default plan
    assert (ids == -1).any() and len(np.unique(ids)) >= 3
    for jb in ("numpy", "jax"):
        want = jgate.get_gate_backend(jb).bank_gate_block(j, z, ids, branch=1)
        for tb in ("numpy", TORCH_CPU):
            got = tgate.get_gate_backend(tb).bank_gate_block(t, z, ids, branch=1)
            # experts' temperatures differ by up to 2e-4 between the fits
            np.testing.assert_allclose(got[0], want[0], rtol=2e-4)
            np.testing.assert_array_equal(got[1], want[1])
    # on one bank, the two port backends and the reference agree to K1's tolerance
    t_same = tbank.PlanBank.from_json(j.to_json())
    want = jgate.get_gate_backend("numpy").bank_gate_block(j, z, ids, branch=1)
    for tb in ("numpy", TORCH_CPU):
        _same_gate(tgate.get_gate_backend(tb).bank_gate_block(t_same, z, ids, branch=1), want)


@pytest.mark.parametrize("vector_at", ["expert", "default"])
def test_bank_gate_block_with_a_vector_expert_matches_reference(drift, vector_at):
    """An expert (or the default plan) calibrated by vector scaling: the
    port's torch backend applies it to that expert's rows on the device
    and gates the block in one pass; the reference's backends are the
    spec. Same bank on both sides, so K1's tolerance holds."""
    val, test, j, _ = drift
    ctx = "gaussian_noise@2"
    z = test["exit_logits"][ctx][2]
    ids = j.estimator.predict_ids(test["features"][ctx])
    ids[::7] = -1
    keys = j.contexts
    target = j.default_context if vector_at == "default" else keys[np.bincount(ids[ids >= 0]).argmax()]
    jb = jbank.PlanBank.from_json(j.to_json())
    vz = val["exit_logits"][target][2]
    jb.plans[target].calibrators[1] = jget_calibrator("vector").fit(
        jnp.asarray(vz), jnp.asarray(val["labels"]))
    tb_bank = tbank.PlanBank.from_json(jb.to_json())
    assert tb_bank.plans[target].calibrators[1].kind == "vector"
    for jname in ("numpy", "jax"):
        want = jgate.get_gate_backend(jname).bank_gate_block(jb, z, ids, branch=1)
        for tb in ("numpy", TORCH_CPU):
            _same_gate(tgate.get_gate_backend(tb).bank_gate_block(tb_bank, z, ids, branch=1),
                       want)


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(2)
    conf = rng.random((4, 2, 500)).astype(np.float32).astype(np.float64)
    pred = rng.integers(0, 10, (4, 2, 500)).astype(np.int64)
    n = 3000
    rows = (rng.integers(0, 4, n), rng.integers(0, 500, n), rng.integers(0, 5, n))
    return conf, pred, rows


@pytest.mark.parametrize("jb", ["numpy", "jax"])
def test_window_gate_backends_match_reference(tables, jb):
    conf, pred, (ctx, smp, _) = tables
    jbk = jgate.get_gate_backend(jb)
    want = jbk.window_gate(jbk.as_table(conf), jbk.as_table(pred), ctx, smp, 1, P_TAR)
    for tb in ("numpy", TORCH_CPU):
        tbk = tgate.get_gate_backend(tb)
        got = tbk.window_gate(tbk.as_table(conf), tbk.as_table(pred), ctx, smp, 1, P_TAR)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-7)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, np.asarray(b))
    empty = tgate.get_gate_backend(TORCH_CPU).window_gate(
        TORCH_CPU.as_table(conf), TORCH_CPU.as_table(pred), [], [], 0, P_TAR)
    assert [len(x) for x in empty] == [0, 0, 0]


@pytest.mark.parametrize("jb", ["numpy", "jax"])
def test_window_gate_cells_backends_match_reference(tables, jb):
    conf, pred, (ctx, smp, cells) = tables
    branch_by_cell, p_by_cell = [0, 1, 1, 0, 1], [0.5, 0.8, 0.65, 0.9, 0.3]
    jbk = jgate.get_gate_backend(jb)
    want = jbk.window_gate_cells(jbk.as_table(conf), jbk.as_table(pred), ctx, smp, cells,
                                 branch_by_cell, p_by_cell, 5)
    for tb in ("numpy", TORCH_CPU):
        tbk = tgate.get_gate_backend(tb)
        got = tbk.window_gate_cells(tbk.as_table(conf), tbk.as_table(pred), ctx, smp, cells,
                                    branch_by_cell, p_by_cell, 5)
        assert sorted(got) == sorted(want)
        for k in ("prediction", "on_device", "on_count", "offload_count"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        np.testing.assert_allclose(got["confidence"], np.asarray(want["confidence"]), rtol=1e-7)
        assert got["on_count"].sum() + got["offload_count"].sum() == len(ctx)


def test_gate_table_matches_reference(drift):
    _, test, j, _ = drift
    t = tbank.PlanBank.from_json(j.to_json())
    args = ({c: z for c, z in test["exit_logits"].items()}, test["final"])
    jt = jgate.GateTable(*args, j, labels=test["labels"], features_by_context=test["features"])
    tt = tgate.GateTable(*args, t, labels=test["labels"], features_by_context=test["features"],
                         backend=TORCH_CPU)
    np.testing.assert_allclose(tt.conf, jt.conf, **CONF_TOL)
    np.testing.assert_array_equal(tt.pred, jt.pred)
    np.testing.assert_array_equal(tt.final_pred, jt.final_pred)
    rng = np.random.default_rng(3)
    ctx, smp = rng.integers(0, len(jt.ctx_keys), 2000), rng.integers(0, 300, 2000)
    np.testing.assert_array_equal(tt.est_ids(ctx, smp), jt.est_ids(ctx, smp))
    for level in (0, 1, 2):
        np.testing.assert_array_equal(tt.cloud_pred(ctx, smp, level), jt.cloud_pred(ctx, smp, level))
    _clear_of(jt.conf, [P_TAR])
    for a, b in zip(tt.gate_window(ctx, smp, 2, P_TAR)[1:], jt.gate_window(ctx, smp, 2, P_TAR)[1:]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- control
def _rescore_args(test, pkg_lat):
    clean = test["exit_logits"]["clean"]
    prof = pkg_lat.paper_2020()
    return dict(
        exit_logits_list=[clean[1], clean[2]],
        edge_times_s=[pkg_lat.edge_time(prof, b) for b in (1, 2)],
        cloud_times_s=[pkg_lat.cloud_time(prof, b) for b in (1, 2)],
        payload_bytes=[pkg_lat.payload_bytes_for(b) for b in (1, 2)],
        uplink_bps=prof.uplink_bps,
        labels=test["labels"],
        final_logits=test["final"]["clean"],
    )


RESCORE_CASES = {
    "legacy": dict(p_tar_grid=[0.7, 0.8, 0.9]),
    "codec_weighted": dict(p_tar_grid=[0.75, 0.85], compression_levels=(0, 1, 2),
                           sample_weight="ramp", arrival_rate_hz=40.0),
    "capped": dict(p_tar_grid=[0.7, 0.8, 0.9], compression_levels=(0, 2), min_accuracy=0.6,
                   max_reliability_gap=0.05, branches=(2,)),
}


@pytest.mark.parametrize("case", sorted(RESCORE_CASES))
def test_rescore_plan_matches_reference(drift, case):
    _, test, j, _ = drift
    kw = dict(RESCORE_CASES[case])
    if kw.get("sample_weight") == "ramp":
        kw["sample_weight"] = np.linspace(0.1, 2.0, len(test["labels"]))
    jplan = j.plan_for("clean")
    tplan = TPlan.from_json(jplan.to_json())
    for bi, z in enumerate(test["exit_logits"]["clean"].values()):
        _clear_of(jplan.gate_block(z, branch=bi)[0], kw["p_tar_grid"])
    jp, jt = jcontrol.rescore_plan(jplan, **_rescore_args(test, jlat), **kw)
    tp, tt = tcontrol.rescore_plan(tplan, **_rescore_args(test, tlat), device="cpu", **kw)
    assert tp.to_json() == jp.to_json()
    assert len(tt) == len(jt)
    for a, b in zip(tt, jt):
        assert sorted(a) == sorted(b)
        for k in a:
            if a[k] is None or isinstance(a[k], int):
                assert a[k] == b[k], k
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-12, err_msg=k)


def test_controller_core_matches_reference(drift):
    _, test, j, t = drift
    exits = {c: test["exit_logits"][c] for c in test["exit_logits"]}
    kw = dict(final_logits=test["final"], labels=test["labels"], compression_levels=(0, 1))
    jcore = jcontrol.ControllerCore(j, jlat.paper_2020(), exits, **kw)
    t_same = tbank.PlanBank.from_json(j.to_json())
    tcore = tcontrol.ControllerCore(t_same, tlat.paper_2020(), exits, backend=TORCH_CPU, **kw)
    assert tcore.context_aware and tcore.ctx_keys == jcore.ctx_keys
    mix = {"clean": 0.5, "contrast@4": 0.3, "gaussian_noise@2": 0.2}
    w = tcore.sample_weight_for_mix(mix)
    np.testing.assert_array_equal(w, jcore.sample_weight_for_mix(mix))
    for (tc, tp), (jc, jp) in zip(tcore._exit_stats, jcore._exit_stats):
        np.testing.assert_allclose(tc, jc, **CONF_TOL)
        np.testing.assert_array_equal(tp, jp)
    plan = t_same.default_plan
    tp_, tt = tcore.rescore(plan, uplink_bps=5e6, p_tar_grid=[0.75, 0.85], sample_weight=w,
                            arrival_rate_hz=20.0)
    jp_, jt = jcore.rescore(j.default_plan, uplink_bps=5e6, p_tar_grid=[0.75, 0.85],
                            sample_weight=w, arrival_rate_hz=20.0)
    assert tp_.to_json() == jp_.to_json()
    assert [(r["exit_index"], r["p_tar"], r["compression_level"]) for r in tt] == \
        [(r["exit_index"], r["p_tar"], r["compression_level"]) for r in jt]
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(a["expected_latency_s"], b["expected_latency_s"], rtol=1e-12)
        assert a["accuracy"] == pytest.approx(b["accuracy"], rel=1e-12)


def test_selection_rules_and_telemetry_primitives_match_reference():
    rng = np.random.default_rng(4)
    table = [dict(exit_index=int(rng.integers(0, 2)), p_tar=float(p), compression_level=0,
                  expected_latency_s=float(rng.random()), uplink_utilization=float(rng.random()),
                  accuracy=float(rng.random()), offload_prob=float(rng.random()),
                  reliability_gap=float(rng.random()) * 0.1)
             for p in (0.7, 0.8, 0.9) for _ in range(4)]
    for kw in (dict(), dict(min_accuracy=0.5), dict(max_reliability_gap=0.03),
               dict(min_accuracy=0.99, max_reliability_gap=0.001)):
        assert tcontrol.select_candidate(table, **kw) == jcontrol.select_candidate(table, **kw)
        assert (tcontrol.choose_with_concession(table, 0.8, 0.6, **kw)
                == jcontrol.choose_with_concession(table, 0.8, 0.6, **kw))
    t = np.sort(rng.uniform(0, 10, 200))
    v = rng.random(200)
    ids = rng.integers(-1, 4, 200)
    for now, win in ((5.0, 1.0), (0.01, 2.0), (20.0, 0.5)):
        assert (tcontrol.windowed_mean(t, v, win, now) == jcontrol.windowed_mean(t, v, win, now))
        assert tcontrol.windowed_rate(t, win, now) == jcontrol.windowed_rate(t, win, now)
        a, b = tcontrol.windowed_mix(t, ids, 4, win, now), jcontrol.windowed_mix(t, ids, 4, win, now)
        assert (a is None and b is None) or np.array_equal(a, b)
    assert tcontrol.latency_stats_ms(v) == jcontrol.latency_stats_ms(v)
    assert tcontrol.on_device_gap(v > 0.5, [0.8]) == jcontrol.on_device_gap(v > 0.5, [0.8])
