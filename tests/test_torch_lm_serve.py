"""Port parity for the LM serving path: `repro_torch.launch.serve`
(prefill and decode steps with the fused exit gates) and
`repro_torch.offload.engine.lm_engine`, against `repro`.

Tolerances: confidences at the logits' tolerance, rtol / atol 2e-4 (the
reference's model tolerance); predictions equal away from ties (top-2
gap above twice that tolerance); gate decisions equal away from
p_tar +- 1e-6 (ROADMAP hazard d); `payload_bytes` equal. On the CPU the
plan path and the `temperatures=` path run the same plain gate and must
agree bit for bit, as the reference asserts of itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core.policy import OffloadPlan as JPlan
from repro.launch import serve as jserve
from repro.models import registry as jregistry
from repro.models import transformer as jtr
from repro.offload.engine import lm_engine as jlm_engine
from repro_torch.configs import get_smoke
from repro_torch.core.calibration import TemperatureScaling
from repro_torch.core.exits import gate_statistics
from repro_torch.core.policy import OffloadPlan
from repro_torch.kernels import compress
from repro_torch.launch.serve import make_prefill_step, make_serve_step
from repro_torch.models import registry, transformer
from repro_torch.offload.engine import lm_engine

TOL = dict(rtol=2e-4, atol=2e-4)
BOUNDARY = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _release_interpret_executables():
    """Drop the interpret-mode codec executables this module compiles."""
    yield
    jax.clear_caches()


def _setup(dtype, **kw):
    """A two-exit smoke qwen3-8b (exits after layers 0 and 2 of 4) at
    vocab 256, the reference's seeded weights in both packages."""
    cfg = jget_smoke("qwen3-8b").replace(dtype=dtype, vocab_size=256, num_layers=4,
                                         exit_layers=(0, 2), **kw)
    jparams = jregistry.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jparams, transformer.params_from_jax(jparams, device="cpu")


@pytest.fixture(scope="module")
def f32():
    return _setup("float32")


def _plan(temps, p_tar=0.5):
    return OffloadPlan(p_tar=p_tar,
                       calibrators=[TemperatureScaling.from_temperature(t) for t in temps])


def _decided(got_pred, want_pred, want_logits, temp):
    """Predictions equal wherever the reference's top-2 gap of z/T clears
    twice the logits' tolerance."""
    z = np.asarray(want_logits, np.float32) / temp
    top2 = np.sort(z, axis=-1)[..., -2:]
    tol = 2 * (TOL["atol"] + TOL["rtol"] * np.abs(top2[..., 1])) / temp
    clear = (top2[..., 1] - top2[..., 0]) > tol
    np.testing.assert_array_equal(np.asarray(got_pred)[clear], np.asarray(want_pred)[clear])
    return int(clear.sum())


# ------------------------------------------------------------ serve steps
def test_serve_steps_accept_plan():
    """The port's twin of tests/test_serving.py::test_serve_steps_accept_plan
    (bf16 smoke qwen3-8b, a seeded init of the port's own)."""
    cfg = get_smoke("qwen3-8b")
    n_exits = len(cfg.exit_layers)
    plan = _plan([1.7] * n_exits)
    params = registry.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {"tokens": np.ones((2, 16), np.int32)}

    out_plan = make_prefill_step(cfg, plan=plan, device="cpu")(params, batch)
    out_temp = make_prefill_step(cfg, temperatures=[1.7] * n_exits, device="cpu")(params, batch)
    assert torch.equal(out_plan["exit_confidence"], out_temp["exit_confidence"])
    assert torch.equal(out_plan["exit_prediction"], out_temp["exit_prediction"])

    caches = registry.init_cache(cfg, 2, 32, device="cpu")
    step = make_serve_step(cfg, plan=plan, device="cpu")
    tok = np.ones((2, 1), np.int32)
    out, _ = step(params, tok, caches, 1)
    assert out["exit_confidence"].shape[0] == n_exits
    assert out["token"].dtype == torch.int32 and tuple(out["token"].shape) == (2,)

    with pytest.raises(ValueError):
        make_prefill_step(cfg, plan=plan, temperatures=[1.0] * n_exits, device="cpu")
    bad = _plan([1.0] * (n_exits + 1))
    with pytest.raises(ValueError):
        make_serve_step(cfg, plan=bad, device="cpu")


@pytest.mark.parametrize("how", ["plan", "temperatures", "uncalibrated"])
def test_serve_steps_match_reference(f32, how):
    cfg, jparams, tparams = f32
    temps = [1.7, 0.8]
    kw = {"plan": dict(plan=_plan(temps)), "temperatures": dict(temperatures=temps),
          "uncalibrated": {}}[how]
    jkw = dict(kw)
    if how == "plan":
        jkw["plan"] = JPlan.from_json(kw["plan"].to_json())
    eff = temps if how != "uncalibrated" else [1.0, 1.0]
    b, s = 8, 12
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)

    got = make_prefill_step(cfg, device="cpu", **kw)(tparams, {"tokens": toks})
    want = jserve.make_prefill_step(cfg, **jkw)(jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), **TOL)
    np.testing.assert_allclose(got["exit_confidence"].numpy(),
                               np.asarray(want["exit_confidence"]), **TOL)
    zs = jtr.forward_prefill(jparams, cfg, {"tokens": jnp.asarray(toks)})["exit_logits"]
    n_clear = sum(_decided(got["exit_prediction"][i], want["exit_prediction"][i], zs[i][:, 0], t)
                  for i, t in enumerate(eff))
    assert n_clear >= b  # most rows are decided, so the check has teeth

    tstep = make_serve_step(cfg, device="cpu", **kw)
    jstep = jax.jit(jserve.make_serve_step(cfg, **jkw))
    jdec = jax.jit(lambda p, t, c, pos: jtr.decode_step(p, cfg, t, c, pos))
    tc = registry.init_cache(cfg, b, s, device="cpu")
    jc = jregistry.init_cache(cfg, b, s)
    jc_twin = jregistry.init_cache(cfg, b, s)
    for t in range(s):
        tok = toks[:, t:t + 1]
        got, tc = tstep(tparams, tok, tc, t)
        want, jc = jstep(jparams, jnp.asarray(tok), jc, jnp.int32(t))
        out, jc_twin = jdec(jparams, jnp.asarray(tok), jc_twin, jnp.int32(t))
        np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), **TOL)
        np.testing.assert_allclose(got["exit_confidence"].numpy(),
                                   np.asarray(want["exit_confidence"]), **TOL)
        for i, temp in enumerate(eff):
            _decided(got["exit_prediction"][i], want["exit_prediction"][i],
                     out["exit_logits"][i][:, 0], temp)
        _decided(got["token"], want["token"], want["logits"], 1.0)


# ---------------------------------------------------------------- lm_engine
def _engine_pair(cfg, jparams, tparams, level, toks):
    """The two engines on one plan: exit 0 at T 1.3, p_tar the midpoint of
    the two middle calibrated confidences of the reference's edge (an even
    count, so no sample sits on it) -- both outcomes occur."""
    z = jtr.edge_forward(jparams, cfg, {"tokens": jnp.asarray(toks)})["exit_logits"][:, 0]
    conf = np.asarray(jax.nn.softmax(np.asarray(z, np.float32) / 1.3, axis=-1).max(-1))
    plan = _plan([1.3, 1.0], p_tar=float(np.median(conf))).with_compression(level)
    teng = lm_engine(tparams, cfg, plan, device="cpu")
    jeng = jlm_engine(jparams, cfg, JPlan.from_json(plan.to_json()))
    return plan, conf, teng, jeng


@pytest.mark.parametrize("level", [0, 1, 2])
def test_lm_engine_matches_reference(f32, level):
    cfg, jparams, tparams = f32
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (16, 16)).astype(np.int32)
    plan, conf, teng, jeng = _engine_pair(cfg, jparams, tparams, level, toks)
    got = teng.infer({"tokens": toks})
    want = jeng.infer({"tokens": jnp.asarray(toks)})
    near = np.abs(conf - plan.p_tar) <= BOUNDARY
    assert not near.any()  # so every decision, and the charged bytes, must agree
    np.testing.assert_array_equal(got["on_device"], want["on_device"])
    on = got["on_device"]
    assert 0 < (~on).sum() < len(on)
    assert teng.stats.payload_bytes == jeng.stats.payload_bytes
    assert teng.stats.offloaded == jeng.stats.offloaded == int((~on).sum())
    np.testing.assert_array_equal(got["prediction"][on], want["prediction"][on])
    np.testing.assert_allclose(got["confidence"][on], want["confidence"][on], **TOL)
    if level == 0:
        np.testing.assert_array_equal(got["prediction"], want["prediction"])
        np.testing.assert_allclose(got["confidence"], want["confidence"], **TOL)
        # the refused rows' cloud logits are the whole model's last position
        full = registry.forward_prefill(tparams, cfg, {"tokens": toks})["logits"][:, 0]
        np.testing.assert_array_equal(got["prediction"][~on],
                                      full.argmax(-1).numpy()[~on])
    assert teng.stats.payload_bytes == int((~on).sum()) * compress.scaled_payload_nbytes(
        16 * cfg.d_model * 4, level)


@pytest.mark.parametrize("level", [1, 2])
def test_lm_engine_codec_feeds_the_cloud_in_float32(level):
    """bf16 weights at a non-zero codec level: `infer`'s refused rows are
    the port's own cloud_forward on roundtrip(hidden), and the reference's
    cloud_forward on the port's decoded float32 payload agrees with the
    port's (both promote the bf16 weights to float32)."""
    cfg, jparams, tparams = _setup("bfloat16")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (16, 16)).astype(np.int32)
    edge = transformer.edge_forward(tparams, cfg, {"tokens": toks})
    conf, _, _ = gate_statistics(edge["exit_logits"][:, 0], 1.3)
    conf = conf.numpy()
    plan = _plan([1.3, 1.0], p_tar=float(np.median(conf))).with_compression(level)
    got = lm_engine(tparams, cfg, plan, device="cpu").infer({"tokens": toks})
    refused = np.flatnonzero(~got["on_device"])
    assert 0 < len(refused) < len(toks)
    hidden = edge["hidden"][refused]
    assert hidden.dtype == torch.bfloat16
    decoded = compress.roundtrip(hidden, level)
    assert decoded.dtype == torch.float32
    mine = transformer.cloud_forward(tparams, cfg, decoded)["logits"][:, 0]
    assert mine.dtype == torch.float32
    p = torch.softmax(mine, dim=-1)
    np.testing.assert_array_equal(got["prediction"][refused], mine.argmax(-1).numpy())
    np.testing.assert_allclose(got["confidence"][refused], p.max(-1).values.numpy(),
                               rtol=1e-6, atol=0)
    theirs = jtr.cloud_forward(jparams, cfg, jnp.asarray(decoded.numpy()))["logits"][:, 0]
    assert theirs.dtype == jnp.float32
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), **TOL)
