"""Port parity for the serving engine: `repro_torch.offload.engine.
convnet_engine(...).infer` against `repro.offload.engine.convnet_engine`
on the same parameters, plan and batch, at codec levels 0, 1 and 2.

Tolerances: `prediction` exact; `on_device` exact except for samples
whose confidence lies within 1e-6 of p_tar (the two gates compute the
confidence by different float32 formulas); `confidence` within 1e-5;
`stats.payload_bytes` equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import OffloadPlan as JPlan
from repro.models import convnet as jconv
from repro.offload.engine import convnet_engine as jengine
from repro_torch.core.calibration import TemperatureScaling
from repro_torch.core.exits import gate_statistics
from repro_torch.core.policy import OffloadPlan
from repro_torch.data.synthetic import cifar_like
from repro_torch.kernels import compress
from repro_torch.models import convnet as tconv
from repro_torch.offload.engine import OffloadEngine, convnet_engine


@pytest.fixture(autouse=True, scope="module")
def _release_interpret_executables():
    """Drop the interpret-mode codec executables this module compiles."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        fan_in = np.prod(node.shape[:-1]) if len(node.shape) > 1 else 100.0
        return (rng.standard_normal(node.shape) / np.sqrt(fan_in)).astype(np.float32)

    tree = draw(jax.eval_shape(jconv.init_params, jax.random.PRNGKey(0)))
    images = cifar_like(n_train=8, n_val=8, n_test=48, seed=3).test_x
    tparams = tconv.params_from_jax(tree, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    return tparams, jparams, images


def _plan(tparams, images, branch, temperature=1.3):
    """A two-exit plan whose p_tar is the median calibrated confidence of
    the deployed branch (numpy's: for an even count, the midpoint of the
    middle two, so no sample sits on the threshold), so both gate
    outcomes occur."""
    logits, _ = tconv.edge_forward(tparams, torch.as_tensor(images), branch=branch)
    conf, _, _ = gate_statistics(logits, temperature)
    conf = conf.numpy()
    plan = OffloadPlan(p_tar=float(np.median(conf)),
                       calibrators=[TemperatureScaling.from_temperature(temperature)] * 2)
    return plan, conf


@pytest.mark.parametrize("branch,level", [(1, 0), (1, 1), (1, 2), (2, 2)])
def test_convnet_engine_matches_reference(setup, branch, level):
    tparams, jparams, images = setup
    plan, conf = _plan(tparams, images, branch)
    plan = plan.with_compression(level)
    teng = convnet_engine(tparams, plan, branch=branch, use_kernel=True, device="cpu")
    jeng = jengine(jparams, JPlan.from_json(plan.to_json()), branch=branch, use_kernel=True)
    got = teng.infer({"images": images})
    want = jeng.infer({"images": jnp.asarray(images)})
    near = np.abs(conf - plan.p_tar) <= 1e-6
    np.testing.assert_array_equal(got["on_device"][~near], want["on_device"][~near])
    agree = got["on_device"] == want["on_device"]
    np.testing.assert_array_equal(got["prediction"][agree], want["prediction"][agree])
    np.testing.assert_allclose(got["confidence"][agree], want["confidence"][agree], atol=1e-5)
    assert 0 < teng.stats.offloaded < len(images)
    assert not near.any()  # so the charged bytes must agree too
    assert teng.stats.payload_bytes == jeng.stats.payload_bytes
    assert teng.stats.payload_bytes == teng.stats.offloaded * compress.scaled_payload_nbytes(
        tconv.payload_bytes(branch), level)


def test_engine_cloud_equals_full_model(setup):
    """Offloaded samples get exactly the full model's prediction."""
    tparams, _, images = setup
    plan = OffloadPlan(p_tar=1.1, calibrators=[TemperatureScaling.from_temperature(1.0)])
    eng = convnet_engine(tparams, plan, device="cpu")  # p_tar > 1: offload all
    out = eng.infer({"images": images})
    assert eng.stats.offloaded == len(images) and eng.stats.cloud_calls == 1
    full = tconv.forward(tparams, torch.as_tensor(images))["logits"]
    np.testing.assert_array_equal(out["prediction"], full.argmax(-1).numpy())
    none = convnet_engine(tparams, plan.with_p_tar(0.0), device="cpu")
    none.infer({"images": images})
    assert none.stats.offloaded == 0 and none.stats.payload_bytes == 0
    assert none.stats.cloud_calls == 0 and none.stats.offload_rate == 0.0


def test_engine_timing_hooks_and_branch_check():
    calls = []
    plan = OffloadPlan(p_tar=0.5, calibrators=[TemperatureScaling.from_temperature(1.0)])
    eng = OffloadEngine(
        edge_fn=lambda b: {"exit_logits": torch.zeros(4, 10), "payload": torch.zeros(4, 8)},
        cloud_fn=lambda p: {"logits": torch.ones(p.shape[0], 10)},
        plan=plan,
        timing_hook=lambda tier, dt, b: calls.append((tier, b)),
    )
    out = eng.infer({"x": None})
    assert out["prediction"].shape == (4,) and eng.policy is plan
    assert eng.stats.edge_calls == 1 and eng.stats.cloud_calls == 1
    assert eng.stats.payload_bytes == 4 * 8 * 4
    assert ("edge", 4) in calls and ("cloud", 4) in calls
    with pytest.raises(ValueError):
        OffloadEngine(lambda b: b, lambda p: p, plan, branch=1)
