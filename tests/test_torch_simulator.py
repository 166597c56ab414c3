"""Port parity for the missed-deadline simulator
(`repro_torch.offload.simulator`) and the uplink models
(`repro_torch.serving.network`) against the reference on the CPU.

The same seeded numpy logits go through both simulators, with a plan and
with legacy temperatures, at one and two branches, with `drop_last` both
ways, and with a Markov network priced at per-batch times. Every
`BatchOutcome` field and every missed-deadline value must be equal: the
bookkeeping is the same float64 numpy arithmetic, and the gate decisions
agree exactly because no confidence lies within 1e-6 of p_tar (K1's
boundary, ROADMAP hazard d; asserted below, not assumed). Network rates
and transfer times are equal, float64 on both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exits as jexits
from repro.core.calibration import TemperatureScaling as JTS
from repro.core.policy import OffloadPlan as JPlan
from repro.offload import latency as jlat
from repro.offload import simulator as jsim
from repro.serving import network as jnet
from repro_torch.core.calibration import TemperatureScaling as TTS
from repro_torch.core.policy import OffloadPlan as TPlan
from repro_torch.offload import latency as tlat
from repro_torch.offload import simulator as tsim
from repro_torch.serving import network as tnet

P_TAR = 0.8
TEMPS = [1.7, 1.3]
T_TARS = [0.5e-3, 1e-3, 2e-3, 3e-3, 5e-3, 7.5e-3, 10e-3, 15e-3, 25e-3, 50e-3]


@pytest.fixture(scope="module")
def logits():
    """Two exits of rising sharpness and a final head: 1100 samples, so
    batches of 512 leave a partial batch of 76."""
    rng = np.random.default_rng(0)
    n = 1100
    y = rng.integers(0, 10, n).astype(np.int32)
    heads = []
    for sharp in (2.0, 4.0, 6.0):
        z = rng.standard_normal((n, 10)).astype(np.float32)
        z[np.arange(n), y] += sharp * rng.random(n).astype(np.float32)
        heads.append(z * 1.5)
    for z, t in zip(heads[:2], TEMPS):
        for temp in (1.0, t):
            conf = np.asarray(jexits.gate_statistics(jnp.asarray(z), temp)[0])
            assert np.abs(conf - P_TAR).min() > 1e-6, "a confidence sits on K1's boundary"
    return heads[:2], heads[2], y


def _plans():
    return (JPlan(p_tar=P_TAR, calibrators=[JTS.from_temperature(t) for t in TEMPS]),
            TPlan(p_tar=P_TAR, calibrators=[TTS.from_temperature(t) for t in TEMPS]))


def _same(t_out, j_out):
    assert len(t_out) == len(j_out) > 0
    for a, b in zip(t_out, j_out):
        assert (a.time_s, a.accuracy, a.on_device_frac) == (b.time_s, b.accuracy,
                                                          b.on_device_frac)


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("branches", [(1,), (1, 2)])
@pytest.mark.parametrize("mode", ["plan", "temperatures"])
def test_simulate_batches_matches_reference(logits, mode, branches, drop_last):
    exits, final, y = logits
    zs = exits[: len(branches)]
    common = dict(batch_size=512, branches=branches, drop_last=drop_last)
    if mode == "plan":
        jplan, tplan = _plans()
        j_out = jsim.simulate_batches(zs, final, y, profile=jlat.paper_2020(), plan=jplan,
                                      **common)
        t_out = tsim.simulate_batches(zs, final, y, profile=tlat.paper_2020(), plan=tplan,
                                      device="cpu", **common)
    else:
        temps = TEMPS[: len(branches)]
        j_out = jsim.simulate_batches(zs, final, y, P_TAR, temps, jlat.paper_2020(), **common)
        t_out = tsim.simulate_batches(zs, final, y, P_TAR, temps, tlat.paper_2020(),
                                      device="cpu", **common)
    assert len(t_out) == (2 if drop_last else 3)
    _same(t_out, j_out)
    assert (tsim.missed_deadline_curve(t_out, T_TARS, P_TAR)
            == jsim.missed_deadline_curve(j_out, T_TARS, P_TAR))


@pytest.mark.parametrize("branches", [(1,), (1, 2)])
def test_simulate_batches_with_markov_network_matches_reference(logits, branches):
    exits, final, y = logits
    zs = exits[: len(branches)]
    times = [0.0, 0.7, 1.9]
    jplan, tplan = _plans()
    j_out = jsim.simulate_batches(zs, final, y, profile=jlat.paper_2020(), plan=jplan,
                                  branches=branches, network=jnet.MarkovNetwork(seed=3),
                                  batch_times_s=times)
    t_out = tsim.simulate_batches(zs, final, y, profile=tlat.paper_2020(), plan=tplan,
                                  branches=branches, network=tnet.MarkovNetwork(seed=3),
                                  batch_times_s=times, device="cpu")
    _same(t_out, j_out)
    fixed = tsim.simulate_batches(zs, final, y, profile=tlat.paper_2020(), plan=tplan,
                                  branches=branches, device="cpu")
    assert [o.time_s for o in t_out] != [o.time_s for o in fixed]  # the link moved
    assert (tsim.missed_deadline_curve(t_out, T_TARS, P_TAR)
            == jsim.missed_deadline_curve(j_out, T_TARS, P_TAR))


def test_simulate_batches_takes_tensors_and_checks_its_inputs(logits):
    exits, final, y = logits
    _, tplan = _plans()
    prof = tlat.paper_2020()
    as_np = tsim.simulate_batches(exits[:1], final, y, profile=prof, plan=tplan, device="cpu")
    as_t = tsim.simulate_batches([torch.as_tensor(exits[0])], torch.as_tensor(final),
                                 torch.as_tensor(y), profile=prof, plan=tplan)
    _same(as_t, as_np)
    with pytest.raises(ValueError, match="LatencyProfile"):
        tsim.simulate_batches(exits[:1], final, y, plan=tplan, device="cpu")
    with pytest.raises(ValueError, match="p_tar, temperatures"):
        tsim.simulate_batches(exits[:1], final, y, profile=prof, device="cpu")
    with pytest.raises(ValueError, match="batch_times_s"):
        tsim.simulate_batches(exits[:1], final, y, profile=prof, plan=tplan,
                              batch_times_s=[0.0], device="cpu")


def _networks(pkg):
    return {
        "fixed": pkg.FixedRateNetwork(18.8e6),
        "markov": pkg.MarkovNetwork(good_bps=20e6, bad_bps=1e6, p_good_to_bad=0.3,
                                    p_bad_to_good=0.4, dwell_s=0.25, seed=7),
        "trace": pkg.TraceNetwork([0.0, 0.5, 1.2], [10e6, 3e6, 25e6]),
        "trace_periodic": pkg.TraceNetwork([0.0, 0.5, 1.2], [10e6, 3e6, 25e6], period_s=2.0),
    }


@pytest.mark.parametrize("name", ["fixed", "markov", "trace", "trace_periodic"])
def test_network_rates_and_comm_time_match_reference(name):
    j, t = _networks(jnet)[name], _networks(tnet)[name]
    times = np.random.default_rng(1).uniform(-0.5, 9.0, 400)
    np.testing.assert_array_equal(t.rates_bps(times), j.rates_bps(times))
    assert [t.rate_bps(x) for x in times[:50]] == [j.rate_bps(x) for x in times[:50]]
    assert [t.comm_time(65536, x) for x in times[:50]] == [j.comm_time(65536, x)
                                                           for x in times[:50]]
    assert tnet.network_for(tlat.paper_2020()) == tnet.FixedRateNetwork(18.8e6)


def test_network_validation_matches_reference():
    for pkg in (jnet, tnet):
        with pytest.raises(ValueError, match="dwell_s"):
            pkg.MarkovNetwork(dwell_s=0.0)
        with pytest.raises(ValueError, match="start at 0"):
            pkg.TraceNetwork([0.1, 0.5], [1e6, 2e6])
        with pytest.raises(ValueError, match="period_s"):
            pkg.TraceNetwork([0.0, 0.5], [1e6, 2e6], period_s=0.5)
        with pytest.raises(ValueError, match="non-positive"):
            pkg.FixedRateNetwork(0.0).comm_time(10)
