"""Port parity for `repro_torch.core` against `repro.core`: calibration
fits, gating, cascades, plans (JSON both ways), partition choice and the
reliability metrics. Inputs come from numpy with a seed and go through
both packages on the CPU.

Tolerances: fitted temperatures rtol 1e-4 (see the note at
`test_fit_temperature_noise_bound_seed`), gate confidences rtol 2e-5 /
atol 1e-6 with decisions exact, plan JSON strings identical.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro.core import exits as jexits
from repro.core import metrics as jmetrics
from repro.core import partition as jpart
from repro.core import policy as jpolicy
from repro_torch.core import calibration as tcal
from repro_torch.core import exits as texits
from repro_torch.core import metrics as tmetrics
from repro_torch.core import partition as tpart
from repro_torch.core import policy as tpolicy


def _planted(n=2000, k=10, t_star=2.5, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((n, k)) * scale).astype(np.float32)
    p = np.exp(z / t_star)
    p /= p.sum(1, keepdims=True)
    y = (p.cumsum(1) > rng.random((n, 1))).argmax(1).astype(np.int32)
    return z, y


def _cascade(n=512, seed=0):
    """Two exits of rising sharpness plus a final head, with labels."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n).astype(np.int32)
    exits = []
    for sharp in (1.5, 3.0, 5.0):
        z = rng.standard_normal((n, 10)).astype(np.float32)
        z[np.arange(n), y] += sharp * rng.random(n).astype(np.float32)
        exits.append(z * 2.0)
    return exits[:2], exits[2], y


T = torch.as_tensor


# ----------------------------------------------------------- calibration
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 6, 7])
def test_fit_temperature_matches_reference(seed):
    z, y = _planted(seed=seed)
    tj, info_j = jcal.fit_temperature(jnp.asarray(z), jnp.asarray(y))
    tt, info_t = tcal.fit_temperature(T(z), T(y))
    np.testing.assert_allclose(float(tt), float(tj), rtol=1e-4)
    np.testing.assert_allclose(float(info_t["nll_after"]), float(info_j["nll_after"]), rtol=1e-6)
    np.testing.assert_allclose(float(info_t["nll_before"]), float(info_j["nll_before"]), rtol=1e-6)


def test_fit_temperature_noise_bound_seed():
    """On this draw the reference keeps its golden-section point over its
    Newton point because the two NLLs differ by one float32 ulp; the port's
    NLL ties the other way and keeps Newton, 1.8e-4 away in T. Both points
    are minimizers to float32 precision: the NLLs agree to 2 ulp."""
    z, y = _planted(seed=5)
    tj, _ = jcal.fit_temperature(jnp.asarray(z), jnp.asarray(y))
    tt, _ = tcal.fit_temperature(T(z), T(y))
    np.testing.assert_allclose(float(tt), float(tj), rtol=5e-4)
    nj = float(jcal.nll(jnp.asarray(z), jnp.asarray(y), tj))
    nt = float(tcal.nll(T(z), T(y), tt))
    assert abs(nj - nt) <= 2 * np.spacing(np.float32(nj))


def test_fit_temperature_weighted_matches_reference():
    z, y = _planted(seed=3)
    w = (np.random.default_rng(9).random(len(y)) < 0.6).astype(np.float32)
    tj, _ = jcal.fit_temperature(jnp.asarray(z), jnp.asarray(y), weights=jnp.asarray(w))
    tt, _ = tcal.fit_temperature(T(z), T(y), weights=T(w))
    np.testing.assert_allclose(float(tt), float(tj), rtol=1e-4)
    np.testing.assert_allclose(float(tcal.nll(T(z), T(y), 1.7, weights=T(w))),
                               float(jcal.nll(jnp.asarray(z), jnp.asarray(y), 1.7,
                                              weights=jnp.asarray(w))), rtol=1e-6)


def test_fit_vector_scaling_matches_reference():
    z, y = _planted(n=500, seed=6)
    wj, bj, _ = jcal.fit_vector_scaling(jnp.asarray(z), jnp.asarray(y), steps=50)
    wt, bt, _ = tcal.fit_vector_scaling(T(z), T(y), steps=50)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sequential", [False, True])
def test_calibrate_cascade_matches_reference(sequential):
    exits, _, y = _cascade()
    tj = jcal.calibrate_cascade([jnp.asarray(z) for z in exits], jnp.asarray(y),
                                sequential=sequential, p_tar=0.7)
    tt = tcal.calibrate_cascade([T(z) for z in exits], T(y), sequential=sequential, p_tar=0.7)
    np.testing.assert_allclose(tt, tj, rtol=1e-4)


def test_calibrator_registry_and_states():
    assert tcal.available_calibrators() == jcal.available_calibrators()
    z, y = _planted(n=300, seed=7)
    for kind in ("temperature", "vector", "identity"):
        cal = tcal.get_calibrator(kind)
        assert isinstance(cal, tcal.Calibrator)
        state = cal.fit(T(z), T(y))
        back = tcal.CalibratorState.from_dict(json.loads(json.dumps(state.to_dict())))
        jstate = jcal.CalibratorState.from_dict(state.to_dict())
        np.testing.assert_allclose(
            tcal.apply_calibrator(back, T(z)).numpy(),
            np.asarray(jcal.apply_calibrator(jstate, jnp.asarray(z))), rtol=1e-6)
    with pytest.raises(KeyError):
        tcal.get_calibrator("nope")


# ---------------------------------------------------------------- gating
def test_gate_and_cascade_match_reference():
    exits, final, y = _cascade()
    conf, pred, ent = texits.gate_statistics(T(exits[0]), 1.7)
    jconf, jpred, jent = jexits.gate_statistics(jnp.asarray(exits[0]), 1.7)
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jent), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    for crit, kw in (("confidence", {}), ("entropy", {"entropy_threshold": 1.5})):
        g = texits.apply_gate(T(exits[1]), 0.6, 1.2, criterion=crit, **kw)
        jg = jexits.apply_gate(jnp.asarray(exits[1]), 0.6, 1.2, criterion=crit, **kw)
        np.testing.assert_array_equal(g.exit_mask.numpy(), np.asarray(jg.exit_mask))
    with pytest.raises(ValueError):
        texits.apply_gate(T(exits[0]), 0.5, criterion="entropy")
    out = texits.cascade_gate([T(z) for z in exits], T(final), 0.6, [1.3, 0.9])
    jout = jexits.cascade_gate([jnp.asarray(z) for z in exits], jnp.asarray(final), 0.6, [1.3, 0.9])
    for k in ("exit_index", "prediction"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    np.testing.assert_allclose(out["confidence"].numpy(), np.asarray(jout["confidence"]),
                               rtol=2e-5, atol=1e-6)


# ----------------------------------------------------------------- plans
def _plans():
    exits, final, y = _cascade()
    jplan = jpolicy.make_plan([jnp.asarray(z) for z in exits], jnp.asarray(y), p_tar=0.7)
    tplan = tpolicy.make_plan(exits, y, p_tar=0.7, device="cpu")
    return exits, final, y, jplan, tplan


def test_make_plan_matches_reference():
    exits, final, y, jplan, tplan = _plans()
    np.testing.assert_allclose(tplan.temperatures, jplan.temperatures, rtol=1e-4)
    for i, z in enumerate(exits):
        g = tplan.gate(T(z), branch=i, use_kernel=True)
        jg = jplan.gate(jnp.asarray(z), branch=i)
        np.testing.assert_array_equal(g.prediction.numpy(), np.asarray(jg.prediction))
    ident = tpolicy.make_plan(exits, y, p_tar=0.7, calibrated=False, device="cpu")
    assert ident.temperatures == [1.0, 1.0]


def test_plan_json_identical_both_directions():
    exits, final, y, jplan, tplan = _plans()
    jplan = jplan.with_partition(1, 1).with_compression(2)
    jplan.metadata["note"] = "lab"
    s = jplan.to_json()
    assert tpolicy.OffloadPlan.from_json(s).to_json() == s
    tplan = tplan.with_partition(0, 0).with_p_tar(0.75).with_compression(1)
    s = tplan.to_json(indent=2)
    assert jpolicy.OffloadPlan.from_json(s).to_json(indent=2) == s
    # a reloaded plan gates identically in either package
    back = tpolicy.OffloadPlan.from_json(jplan.to_json())
    for i, z in enumerate(exits):
        np.testing.assert_array_equal(
            back.gate(T(z), branch=i).exit_mask.numpy(),
            np.asarray(jplan.gate(jnp.asarray(z), branch=i).exit_mask))
    d = tplan.to_dict()
    d["version"] = tpolicy.PLAN_FORMAT_VERSION + 1
    with pytest.raises(ValueError):
        tpolicy.OffloadPlan.from_dict(d)
    with pytest.raises(ValueError):
        tplan.gate(T(exits[0]), branch=5)


def test_plan_files_load_in_either_package(tmp_path):
    """A legacy temperature-list plan saved by the reference loads here, and
    a plan saved here loads in the reference, to the identical JSON."""
    legacy = jpolicy.OffloadPolicy(p_tar=0.6, temperatures=[1.5, 2.0])
    path = str(tmp_path / "legacy.json")
    legacy.save(path)
    plan = tpolicy.OffloadPlan.load(path)
    assert plan.temperatures == [1.5, 2.0] and plan.metadata == {"calibrated": True}
    assert plan.to_json() == legacy.to_json()
    path = str(tmp_path / "port.json")
    plan.with_p_tar(0.7).save(path)
    assert jpolicy.OffloadPlan.load(path).to_json() == plan.with_p_tar(0.7).to_json()


# ------------------------------------------------------------- partition
def test_select_partition_matches_reference():
    exits, final, y, jplan, tplan = _plans()
    args = dict(edge_times_s=[1.1e-3, 2.3e-3], cloud_times_s=[5.2e-3, 4.1e-3],
                payload_bytes=[65536, 24576], exit_layer_indices=[0, 1], uplink_bps=18.8e6)
    jplan = jpolicy.OffloadPlan.from_json(tplan.to_json())
    new_t, cands_t = tpart.select_partition(tplan, [T(z) for z in exits], **args)
    new_j, cands_j = jpart.select_partition(jplan, [jnp.asarray(z) for z in exits], **args)
    assert new_t.to_json() == new_j.to_json()
    assert [c.__dict__ for c in cands_t] == [c.__dict__ for c in cands_j]
    legacy = tpart.choose_partition([T(z) for z in exits], temperatures=[1.0, 1.0], p_tar=0.8,
                                    **{k: v for k, v in args.items()})
    jlegacy = jpart.choose_partition([jnp.asarray(z) for z in exits], temperatures=[1.0, 1.0],
                                     p_tar=0.8, **args)
    assert [c.__dict__ for c in legacy] == [c.__dict__ for c in jlegacy]
    with pytest.raises(ValueError):
        tpart.choose_partition([T(exits[0])])


# --------------------------------------------------------------- metrics
def test_metrics_match_reference():
    exits, final, y = _cascade(n=1536)
    z = exits[1]
    conf, pred, _ = texits.gate_statistics(T(z), 1.3)
    correct = (pred.numpy() == y)
    assert tmetrics.ece(conf, correct) == pytest.approx(
        jmetrics.ece(np.asarray(conf), correct), abs=1e-12)
    rows_t = tmetrics.reliability_diagram(conf, correct)
    rows_j = jmetrics.reliability_diagram(conf.numpy(), correct)
    np.testing.assert_allclose(np.array(rows_t, float), np.array(rows_j, float), equal_nan=True)
    ds = tmetrics.device_statistics(T(z), T(y), 0.6, 1.3)
    jds = jmetrics.device_statistics(jnp.asarray(z), jnp.asarray(y), 0.6, 1.3)
    for k in ds:
        np.testing.assert_allclose(float(ds[k]), float(jds[k]), rtol=1e-5)
    assert tmetrics.overall_accuracy([T(e) for e in exits], T(final), T(y), 0.6, [1.0, 1.3]) == \
        pytest.approx(jmetrics.overall_accuracy([jnp.asarray(e) for e in exits],
                                                jnp.asarray(final), jnp.asarray(y), 0.6,
                                                [1.0, 1.3]), abs=1e-7)
    for p_tar in (0.3, 0.6, 0.9):
        assert tmetrics.inference_outage_probability(T(z), T(y), p_tar, 1.3) == \
            jmetrics.inference_outage_probability(jnp.asarray(z), jnp.asarray(y), p_tar, 1.3)
        assert tmetrics.inference_outage_probability(
            T(z), T(y), p_tar, 1.3, rng=np.random.default_rng(2)) == \
            jmetrics.inference_outage_probability(
                jnp.asarray(z), jnp.asarray(y), p_tar, 1.3, rng=np.random.default_rng(2))
        assert tmetrics.outage_probability_cascade([T(e) for e in exits], T(y), p_tar) == \
            jmetrics.outage_probability_cascade([jnp.asarray(e) for e in exits],
                                                jnp.asarray(y), p_tar)


# ------------------------------------------------- the deprecated shims
def test_policy_shims_match_reference():
    """OffloadPolicy and make_policy (the seed API's shims) build the
    reference's plans and gate as the reference's do, from either
    package's exports."""
    import repro_torch.core as tcore

    assert tcore.OffloadPolicy is tpolicy.OffloadPolicy and tcore.make_policy is tpolicy.make_policy
    exits, _, y = _cascade()
    for kw in (dict(criterion="confidence"), dict(criterion="entropy", entropy_threshold=1.2,
                                                  exit_index=1, calibrated=False)):
        tpol = tpolicy.OffloadPolicy(p_tar=0.65, temperatures=[1.5, 2.0], **kw)
        jpol = jpolicy.OffloadPolicy(p_tar=0.65, temperatures=[1.5, 2.0], **kw)
        assert isinstance(tpol, tpolicy.OffloadPlan) and tpol.calibrated == jpol.calibrated
        assert tpol.to_json() == jpol.to_json()
        for i, z in enumerate(exits):
            g, jg = tpol.gate(T(z), branch=i), jpol.gate(jnp.asarray(z), branch=i)
            np.testing.assert_array_equal(g.exit_mask.numpy(), np.asarray(jg.exit_mask))
            np.testing.assert_array_equal(g.prediction.numpy(), np.asarray(jg.prediction))
    for calibrated in (False, True):
        for sequential in (False, True):
            tplan = tpolicy.make_policy(exits, y, p_tar=0.8, calibrated=calibrated,
                                        sequential=sequential, device="cpu")
            jplan = jpolicy.make_policy([jnp.asarray(z) for z in exits], jnp.asarray(y),
                                        p_tar=0.8, calibrated=calibrated, sequential=sequential)
            np.testing.assert_allclose(tplan.temperatures, jplan.temperatures, rtol=1e-4)
            for i, z in enumerate(exits):
                g, jg = tplan.gate(T(z), branch=i), jplan.gate(jnp.asarray(z), branch=i)
                clear = np.abs(g.confidence.numpy() - 0.8) > 1e-3  # away from p_tar (fit gap)
                np.testing.assert_array_equal(g.exit_mask.numpy()[clear],
                                              np.asarray(jg.exit_mask)[clear])


# ------------------------------------------------- the measured H100 profile
def _stats(edge_s, cloud_s, requests=4096, offloaded=1024):
    from repro_torch.offload.engine import EngineStats

    return EngineStats(requests=requests, offloaded=offloaded, edge_time_s=edge_s * requests,
                       cloud_time_s=cloud_s * offloaded)


def test_h100_profile_gives_back_the_measured_times():
    from repro.offload import latency as jlat
    from repro_torch.offload import latency as tlat

    edge = {1: 2.6e-6, 2: 3.9e-6}
    cloud = {1: 9.4e-6, 2: 8.1e-6}
    prof = tlat.h100({b: _stats(edge[b], cloud[b]) for b in (1, 2)}, uplink_bps=18.8e6)
    assert prof.name == "h100" and prof.uplink_bps == 18.8e6
    assert set(prof.edge_layer_s) == set(prof.cloud_layer_s) == set(tlat._alexnet_layer_flops())
    assert set(prof.branch_s) == {"branch1", "branch2"}
    for table in (prof.edge_layer_s, prof.cloud_layer_s, prof.branch_s):
        assert all(v > 0 for v in table.values())
    for b in (1, 2):
        assert tlat.edge_time(prof, b) == pytest.approx(edge[b], rel=1e-12)
        assert tlat.cloud_time(prof, b) == pytest.approx(cloud[b], rel=1e-12)
        # the reference's path sums read the same profile alike
        assert jlat.edge_time(prof, b) == tlat.edge_time(prof, b)
        assert jlat.cloud_time(prof, b) == tlat.cloud_time(prof, b)
        assert tlat.comm_time(prof, b, level=2) == jlat.comm_time(prof, b, level=2)
    # split in proportion to the layers' FLOPs
    flops = tlat._alexnet_layer_flops()
    assert (prof.cloud_layer_s["conv3"] / prof.cloud_layer_s["fc1"]
            == pytest.approx(flops["conv3"] / flops["fc1"], rel=1e-12))
    assert prof.cloud_layer_s["conv2"] == pytest.approx(cloud[1] - cloud[2], rel=1e-9)
    assert (prof.edge_layer_s["conv1"] / prof.branch_s["branch1"]
            == pytest.approx(flops["conv1"] / tlat._BRANCH_FLOPS["branch1"], rel=1e-12))


def test_h100_profile_refuses_contradicting_or_missing_measurements():
    from repro_torch.offload import latency as tlat

    with pytest.raises(ValueError, match="contradict"):  # branch 2's cloud path is a subset
        tlat.h100({1: _stats(2e-6, 5e-6), 2: _stats(3e-6, 6e-6)}, uplink_bps=1e9)
    with pytest.raises(ValueError, match="branches 1 and 2"):
        tlat.h100({1: _stats(2e-6, 5e-6)}, uplink_bps=1e9)
    with pytest.raises(ValueError, match="offloaded"):
        tlat.h100({1: _stats(2e-6, 5e-6), 2: _stats(3e-6, 4e-6, offloaded=0)}, uplink_bps=1e9)
