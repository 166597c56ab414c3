"""Port parity for the decoder-only transformer: `repro_torch.models.
transformer` (through `models.registry`) against `repro.models.transformer`
on the reference's own seeded parameters, carried across with
`params_from_jax`.

Float32 smoke configs of qwen3-8b (qk-norm), qwen2-72b (QKV bias; and
with a sliding window of 8) and olmo-1b (tied embeddings, non-parametric
LayerNorm), plus 4-layer variants whose stacked segments take the
per-layer loops. Tolerance rtol / atol 2e-4, the reference's own
(`tests/test_models.py`). The reference's norm scales and biases start as
ones and zeros; they are redrawn here so that a mis-wired norm shows.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core.exits import gate_statistics as jgate
from repro.models import registry as jregistry
from repro.models import transformer as jtr
from repro_torch.core.exits import gate_statistics
from repro_torch.models import registry, transformer

TOL = dict(rtol=2e-4, atol=2e-4)
CASES = {
    "qwen3-8b": ("qwen3-8b", {}),
    "qwen2-72b": ("qwen2-72b", {}),
    "qwen2-72b-sw8": ("qwen2-72b", {"sliding_window": 8}),
    "olmo-1b": ("olmo-1b", {}),
    # [L0 exit] [L1-2 stacked, exit] [L3]
    "qwen3-8b-4L": ("qwen3-8b", {"num_layers": 4, "exit_layers": (0, 2)}),
    # [L0 exit] [L1-3 stacked], tied embeddings
    "olmo-1b-4L": ("olmo-1b", {"num_layers": 4}),
}
B, S = 2, 16


def _cfg(name, dtype="float32"):
    arch, kw = CASES[name]
    return jget_smoke(arch).replace(dtype=dtype, **kw)


def _redraw_constants(tree, seed):
    """Norm scales (all ones) and biases (all zeros) -> random values."""
    rng = np.random.default_rng(seed)

    def redraw(a):
        a = np.asarray(a)
        if a.size > 1 and np.all(a == a.flat[0]):
            v = rng.uniform(0.5, 1.5, a.shape) if a.flat[0] == 1 else rng.normal(0, 0.1, a.shape)
            return jnp.asarray(v.astype(np.float32)).astype(a.dtype)
        return jnp.asarray(a)

    return jax.tree.map(redraw, tree)


@functools.lru_cache(maxsize=None)
def _setup(name, dtype="float32"):
    cfg = _cfg(name, dtype)
    jparams = _redraw_constants(jregistry.init_params(jax.random.PRNGKey(0), cfg), seed=1)
    tparams = transformer.params_from_jax(jparams, device="cpu")
    return cfg, jparams, tparams


def _tokens(cfg, b=B, s=S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


# --------------------------------------------------------------- parameters
def test_params_from_jax_keeps_tree_dtypes_and_count():
    cfg, jparams, tparams = _setup("qwen3-8b-4L")
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    tl = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda a: a, tparams, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, j), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype)
    assert transformer.num_params(tparams) == sum(a.size for a in jax.tree.leaves(jparams))
    # bf16 leaves cross exactly; float32 leaves (norms) stay float32
    _, jb, tb = _setup("qwen3-8b", "bfloat16")
    wq = tb["segments"][0]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and tb["segments"][0]["attn"]["q_norm"].dtype == torch.float32
    assert np.array_equal(wq.float().numpy(),
                          np.asarray(jb["segments"][0]["attn"]["wq"], np.float32))


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen2-72b", "olmo-1b", "qwen3-8b-4L"])
def test_seeded_init_has_the_reference_tree(name):
    """The port's own seeded init: the reference's tree, shapes and dtypes
    (bf16), and param_count() plus the scalars it leaves out: the final
    norm's scale and the qk-norm scales."""
    cfg = _cfg(name, "bfloat16")
    tparams = registry.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    jshapes = jax.eval_shape(lambda k: jregistry.init_params(k, cfg), jax.random.PRNGKey(0))
    jl = jax.tree.leaves(jshapes)
    tl = jax.tree.leaves(jax.tree.map(lambda a: a, tparams,
                                      is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert [(a.shape, str(a.dtype)) for a in jl] == [(tuple(t.shape), str(t.dtype)[6:])
                                                      for t in tl]
    extra = (cfg.d_model if cfg.norm_type != "nonparametric_ln" else 0) + (
        2 * cfg.head_dim * cfg.num_layers if cfg.qk_norm else 0)
    assert transformer.num_params(tparams) == cfg.param_count() + extra


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("name", list(CASES))
def test_forward_train_and_prefill_match_reference(name):
    cfg, jparams, tparams = _setup(name)
    toks = _tokens(cfg)
    want = jax.jit(lambda p, t: jtr.forward_train(p, cfg, {"tokens": t}, remat=False))(
        jparams, jnp.asarray(toks))
    got = registry.forward_train(tparams, cfg, {"tokens": toks})
    _close(got["logits"], want["logits"])
    assert len(got["exit_logits"]) == len(want["exit_logits"]) == len(cfg.exit_layers)
    for g, w in zip(got["exit_logits"], want["exit_logits"]):
        _close(g, w)
    assert float(got["moe_aux_loss"]) == 0.0

    want = jax.jit(lambda p, t: jtr.forward_prefill(p, cfg, {"tokens": t}))(
        jparams, jnp.asarray(toks))
    got = registry.forward_prefill(tparams, cfg, {"tokens": toks})
    _close(got["logits"], want["logits"])
    for g, w in zip(got["exit_logits"], want["exit_logits"]):
        _close(g, w)
    assert len(got["caches"]) == len(want["caches"]) == len(transformer.segment_plan(cfg))
    for g, w in zip(got["caches"], want["caches"]):
        _close(g["k"], w["k"])
        _close(g["v"], w["v"])


@pytest.mark.parametrize("unroll", [False, True])
@pytest.mark.parametrize("name", ["qwen3-8b", "qwen2-72b-sw8", "qwen3-8b-4L", "olmo-1b-4L"])
def test_decode_step_matches_reference(name, unroll):
    cfg, jparams, tparams = _setup(name)
    cfg = cfg.replace(decode_unroll=unroll)
    toks = _tokens(cfg, seed=1)
    jstep = jax.jit(lambda p, t, c, pos: jtr.decode_step(p, cfg, t, c, pos))
    jc = jtr.init_cache(cfg, B, S)
    tc = registry.init_cache(cfg, B, S, device="cpu")
    for c_t, c_j in zip(tc, jc):
        assert tuple(c_t["k"].shape) == c_j["k"].shape
    for t in range(S):
        want, jc = jstep(jparams, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        got, tc = registry.decode_step(tparams, cfg, toks[:, t:t + 1], tc, t)
        _close(got["logits"], want["logits"])
        for g, w in zip(got["exit_logits"], want["exit_logits"]):
            _close(g, w)
    for g, w in zip(tc, jc):
        _close(g["k"], w["k"])


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen2-72b", "qwen2-72b-sw8", "olmo-1b",
                                  "qwen3-8b-4L"])
def test_port_prefill_decode_equivalence(name):
    """Stepwise decode reproduces teacher-forced prefill logits (the port's
    own twin of tests/test_models.py::test_prefill_decode_equivalence)."""
    cfg, _, tparams = _setup(name)
    toks = _tokens(cfg, seed=2)
    full = registry.forward_train(tparams, cfg, {"tokens": toks})
    for unroll in (False, True):
        c = cfg.replace(decode_unroll=unroll)
        caches = registry.init_cache(c, B, S, device="cpu")
        outs, exits = [], []
        for t in range(S):
            out, caches = registry.decode_step(tparams, c, toks[:, t:t + 1], caches, t)
            outs.append(out["logits"][:, 0])
            exits.append(out["exit_logits"][0][:, 0])
        np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full["logits"].numpy(), **TOL)
        np.testing.assert_allclose(torch.stack(exits, 1).numpy(),
                                   full["exit_logits"][0].numpy(), **TOL)


@pytest.mark.parametrize("name,exit_index", [("qwen3-8b", 0), ("olmo-1b", 0),
                                             ("qwen2-72b-sw8", 0), ("qwen3-8b-4L", 0),
                                             ("qwen3-8b-4L", 1), ("olmo-1b-4L", 0)])
def test_edge_and_cloud_forward_match_reference(name, exit_index):
    cfg, jparams, tparams = _setup(name)
    toks = _tokens(cfg, seed=3)
    want = jtr.edge_forward(jparams, cfg, {"tokens": jnp.asarray(toks)}, exit_index=exit_index)
    got = transformer.edge_forward(tparams, cfg, {"tokens": toks}, exit_index=exit_index)
    _close(got["exit_logits"], want["exit_logits"])
    _close(got["hidden"], want["hidden"])
    assert len(got["caches"]) == len(want["caches"])
    hidden = np.array(want["hidden"])  # the same payload into both clouds
    _close(transformer.cloud_forward(tparams, cfg, torch.from_numpy(hidden), exit_index)["logits"],
           jtr.cloud_forward(jparams, cfg, jnp.asarray(hidden), exit_index)["logits"])
    # the partitions compose to the whole model
    full = registry.forward_prefill(tparams, cfg, {"tokens": toks})
    cloud = transformer.cloud_forward(tparams, cfg, got["hidden"], exit_index)
    np.testing.assert_allclose(cloud["logits"].numpy(), full["logits"].numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not found"):
        transformer.edge_forward(tparams, cfg, {"tokens": toks}, exit_index=len(cfg.exit_layers))


def test_cloud_forward_promotes_a_float32_payload_over_bf16_weights():
    """The codec decodes to float32; JAX then runs the bf16-weight cloud
    partition in float32, and so must the port (each weight cast up)."""
    cfg, jparams, tparams = _setup("qwen3-8b-4L", "bfloat16")
    hidden = np.random.default_rng(4).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    want = jtr.cloud_forward(jparams, cfg, jnp.asarray(hidden), 0)["logits"]
    got = transformer.cloud_forward(tparams, cfg, torch.from_numpy(hidden), 0)["logits"]
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, want)


def test_bf16_decisions_agree_with_reference():
    """bf16 qwen3-8b smoke, the reference's weights, 256 sequences.

    Derived tolerance: each package rounds every op's output on the exit's
    path to bf16 (unit roundoff u = 2^-8). The path has 16 such roundings
    (norm, q/k/v, rope, scores, probs, PV, wo, residual, norm, gate/up,
    silu*up, down, residual, exit norm, unembed), and the unit-scale
    weights pass each error on with gain about 1, so the two packages'
    exit logits differ by at most 16 u max|z|; the test asserts that.

    Decisions are then held where the measured logit gap g = max|dz|
    (about 1.8 u max|z| here) cannot flip them: predictions wherever the
    reference's top-2 margin exceeds 2 g, and exit decisions wherever
    |conf - p_tar| exceeds conf (exp(2 g / T) - 1), at five p_tars spread
    over the reference's confidences. Both follow from |dz| <= g alone.
    The test asks that at least half the predictions (207 of 256 here)
    and half the exit decisions (1129 of 1280 here) are held so."""
    cfg, jparams, tparams = _setup("qwen3-8b", "bfloat16")
    toks = _tokens(cfg, b=256, seed=5)
    want = jtr.forward_prefill(jparams, cfg, {"tokens": jnp.asarray(toks)})["exit_logits"][0]
    got = registry.forward_prefill(tparams, cfg, {"tokens": toks})["exit_logits"][0]
    assert got.dtype == torch.bfloat16
    zj = np.asarray(want[:, 0], np.float32)
    zt = got[:, 0].float().numpy()
    gap = np.abs(zt - zj).max()
    assert gap <= 16 * 2.0 ** -8 * np.abs(zj).max()
    temp = 1.7
    cj, pj, _ = (np.asarray(a) for a in jgate(jnp.asarray(zj), temp))
    ct, pt, _ = (a.numpy() for a in gate_statistics(torch.from_numpy(zt), temp))
    top2 = np.sort(zj, axis=1)[:, -2:]
    decidable = (top2[:, 1] - top2[:, 0]) > 2 * gap
    assert np.array_equal(pt[decidable], pj[decidable])
    n_far = 0
    p_tars = np.quantile(cj, [0.1, 0.3, 0.5, 0.7, 0.9])
    for p_tar in p_tars:
        far = np.abs(cj - p_tar) > cj * (np.exp(2 * gap / temp) - 1)
        assert np.array_equal((ct >= p_tar)[far], (cj >= p_tar)[far])
        n_far += int(far.sum())
    assert 2 * decidable.sum() >= len(zj) and 2 * n_far >= len(zj) * len(p_tars), \
        (decidable.sum(), n_far)
