"""Port parity for the LM building blocks: `repro_torch.configs` (every
architecture), `models.layers`, `models.attention`, `data.pipeline`, and
the registry's reach over every family (`models.transformer`,
`models.whisper`).

The same numpy inputs and parameters go through `repro` and
`repro_torch`. Tolerances: configs equal field by field; layers rtol
1e-5 (atol 1e-6 for values near 0); attention rtol / atol 2e-4, the
reference's own model tolerance (`tests/test_models.py`); the iterators'
arrays equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tpipe
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models import registry, transformer

LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_configs_equal_reference(arch):
    for getter in ("get_config", "get_smoke"):
        got = getattr(tconfigs, getter)(arch)
        want = getattr(jconfigs, getter)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, getter)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert got.layer_plan() == want.layer_plan()


def test_registry_lists_aliases_and_shapes():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs._ALIASES == jconfigs._ALIASES
    for alias in jconfigs._ALIASES:
        assert (dataclasses.asdict(tconfigs.get_config(alias))
                == dataclasses.asdict(jconfigs.get_config(alias)))
    assert ({k: dataclasses.asdict(v) for k, v in tconfigs.INPUT_SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()})
    cfg = jconfigs.get_config("qwen3-8b")
    assert (dataclasses.asdict(tconfigs.smoke_variant(tconfigs.get_config("qwen3-8b")))
            == dataclasses.asdict(jconfigs.smoke_variant(cfg)))


# ------------------------------------------------------------------- layers
def _cfg(**kw):
    return jconfigs.get_smoke("qwen3-8b").replace(dtype="float32", **kw)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm", "nonparametric_ln"])
def test_norms_match_reference(norm_type):
    rng = np.random.default_rng(0)
    cfg = _cfg(norm_type=norm_type)
    x = (rng.standard_normal((3, 5, cfg.d_model)) * 3 + 0.5).astype(np.float32)
    p = {}
    if norm_type != "nonparametric_ln":
        p["scale"] = rng.standard_normal(cfg.d_model).astype(np.float32)
    if norm_type == "layernorm":
        p["bias"] = rng.standard_normal(cfg.d_model).astype(np.float32)
    got = tl.apply_norm({k: _t(v) for k, v in p.items()}, cfg, _t(x))
    want = jl.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, cfg, jnp.asarray(x))
    _close(got, want, LAYER_TOL)
    # qk-norm, over the last axis of (b, s, heads, head_dim)
    q = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    _close(tl.rms_norm_headwise(_t(q), _t(scale)),
           jl.rms_norm_headwise(jnp.asarray(q), jnp.asarray(scale)), LAYER_TOL)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlp_matches_reference(mlp_type):
    rng = np.random.default_rng(1)
    cfg = _cfg(mlp_type=mlp_type)
    p = jl.init_mlp(jax.random.PRNGKey(0), cfg)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    got = tl.apply_mlp({k: _t(v) for k, v in p.items()}, cfg, _t(x))
    want = jl.apply_mlp(p, cfg, jnp.asarray(x))
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(2)
    cfg = _cfg(rope_theta=theta)
    pos = np.stack([np.arange(0, 4096, 64), np.arange(7, 4103, 64)]).astype(np.int32)
    x = rng.standard_normal((2, pos.shape[1], 4, cfg.head_dim)).astype(np.float32)
    tc, ts = tl.rope_freqs(cfg, _t(pos))
    jc, js = jl.rope_freqs(cfg, jnp.asarray(pos))
    _close(tc, jc, LAYER_TOL)
    _close(ts, js, LAYER_TOL)
    _close(tl.apply_rope(_t(x), tc, ts), jl.apply_rope(jnp.asarray(x), jc, js), LAYER_TOL)


def test_embed_unembed_and_mixed_dtype_product():
    rng = np.random.default_rng(3)
    cfg = _cfg()
    w = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, cfg.vocab_size, (2, 5))
    _close(tl.apply_embed({"w": _t(w)}, _t(tok)),
           jl.apply_embed({"w": jnp.asarray(w)}, jnp.asarray(tok)), dict(rtol=0, atol=0))
    # bf16 weight x float32 activation: JAX computes in float32; so does the port
    wb = jnp.asarray(w.T[:, :64]).astype(jnp.bfloat16)
    x = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    want = jl.apply_unembed({"w": wb}, jnp.asarray(x))
    got = tl.apply_unembed({"w": _t(np.asarray(wb, np.float32)).to(torch.bfloat16)}, _t(x))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, want, LAYER_TOL)


# ---------------------------------------------------------------- attention
def _attn_setup(seed=0, **kw):
    cfg = _cfg(**kw)
    p = jattn.init_attention(jax.random.PRNGKey(seed), cfg)
    if cfg.qk_norm:  # non-trivial scales, so the qk-norm path is seen
        rng = np.random.default_rng(seed)
        p = dict(p, q_norm=jnp.asarray(rng.uniform(0.5, 1.5, cfg.head_dim), jnp.float32),
                 k_norm=jnp.asarray(rng.uniform(0.5, 1.5, cfg.head_dim), jnp.float32))
    if cfg.qkv_bias:
        rng = np.random.default_rng(seed + 1)
        p = dict(p, **{k: jnp.asarray(rng.standard_normal(p[k].shape) * 0.3, jnp.float32)
                       for k in ("bq", "bk", "bv")})
    tp = transformer.params_from_jax(p, device="cpu")
    return cfg, p, tp


@pytest.mark.parametrize("kw", [{}, {"qkv_bias": True, "qk_norm": False},
                                {"sliding_window": 8}])
def test_prefill_matches_reference_chunked_and_not(kw):
    cfg, p, tp = _attn_setup(**kw)
    rng = np.random.default_rng(4)
    b, s = 2, 32
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want, wcache = jattn.attention_prefill(p, cfg, jnp.asarray(x), jnp.asarray(pos), q_chunk=8)
    full, _ = tattn.attention_prefill(tp, cfg, _t(x), _t(pos))
    chunked, cache = tattn.attention_prefill(tp, cfg, _t(x), _t(pos), q_chunk=8)
    _close(full, want, MODEL_TOL)
    _close(chunked, want, MODEL_TOL)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), rtol=1e-5, atol=1e-6)
    _close(cache["k"], wcache["k"], MODEL_TOL)
    _close(cache["v"], wcache["v"], MODEL_TOL)


def test_cross_attention_memory_matches_reference():
    cfg, p, tp = _attn_setup(seed=1, qkv_bias=True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    pos = np.zeros((2, 6), np.int32)
    want, wc = jattn.attention_prefill(p, cfg, jnp.asarray(x), jnp.asarray(pos),
                                       memory=jnp.asarray(mem))
    got, tc = tattn.attention_prefill(tp, cfg, _t(x), _t(pos), memory=_t(mem))
    _close(got, want, MODEL_TOL)
    # one-token decode against the projected memory: no mask, no cache write
    wd, _ = jattn.attention_decode(p, cfg, jnp.asarray(x[:, :1]), None, jnp.int32(0),
                                   memory_cache=wc)
    td, same = tattn.attention_decode(tp, cfg, _t(x[:, :1]), None, 0, memory_cache=tc)
    assert same is None
    _close(td, wd, MODEL_TOL)


@pytest.mark.parametrize("window,steps", [(0, 12), (8, 20)])
def test_decode_and_stacked_decode_match_reference(window, steps):
    """One layer's decode, step by step, against the reference's decode
    and its stacked-cache decode (layer 1 of a 2-layer stack); with a
    window of 8 over 20 steps the ring buffer wraps twice."""
    cfg, p, tp = _attn_setup(seed=2, sliding_window=window)
    rng = np.random.default_rng(6)
    b = 2
    xs = rng.standard_normal((steps, b, 1, cfg.d_model)).astype(np.float32)
    jc = jattn.init_kv_cache(cfg, b, steps)
    js = jax.tree.map(lambda a: jnp.stack([a, a]), jc)
    tc = tattn.init_kv_cache(cfg, b, steps, "cpu")
    ts = {k: torch.stack([v, v.clone()]) for k, v in tattn.init_kv_cache(cfg, b, steps,
                                                                          "cpu").items()}
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape)
    for t in range(steps):
        wo, jc = jattn.attention_decode(p, cfg, jnp.asarray(xs[t]), jc, jnp.int32(t))
        wso, js = jattn.attention_decode_stacked(p, cfg, jnp.asarray(xs[t]), js, jnp.int32(t), 1)
        to, tc = tattn.attention_decode(tp, cfg, _t(xs[t]), tc, t)
        tso, ts = tattn.attention_decode_stacked(tp, cfg, _t(xs[t]), ts, t, 1)
        _close(to, wo, MODEL_TOL)
        _close(tso, wso, MODEL_TOL)
    _close(tc["k"], jc["k"], MODEL_TOL)
    _close(ts["v"], js["v"], MODEL_TOL)


def test_decode_past_the_cache_raises_without_a_window():
    cfg, _, tp = _attn_setup()
    cache = tattn.init_kv_cache(cfg, 1, 4, "cpu")
    x = torch.zeros((1, 1, cfg.d_model))
    with pytest.raises(ValueError, match="outside the cache"):
        tattn.attention_decode(tp, cfg, x, cache, 4)
    with pytest.raises(ValueError, match="outside the cache"):
        stacked = {k: v[None] for k, v in cache.items()}
        tattn.attention_decode_stacked(tp, cfg, x, stacked, 4, 0)


def test_ring_buffer_age_is_a_floor_modulo():
    """Slot 1 at position 9 of a window of 8: the slots after it hold the
    older positions, so their ages (slot - idx) mod 8 are 1..7, never
    negative."""
    cfg = _cfg(sliding_window=8)
    valid = tattn._valid(cfg, 9, 1, 8, "cpu")
    assert valid.all()
    assert tattn._valid(cfg, 2, 2, 8, "cpu").tolist() == [True] * 3 + [False] * 5


def _k5_route_open(monkeypatch):
    """`qk_rope.takes` made true for the CPU tensors here, so that the
    route to K5's op opens (the op then runs its CPU implementation, the
    plain chain); returns the list its calls are counted in."""
    calls = []
    op = tattn.qk_rope.qk_norm_rope
    monkeypatch.setattr(tattn.qk_rope, "takes", lambda q, k, positions: True)
    monkeypatch.setattr(tattn.qk_rope, "qk_norm_rope",
                        lambda *a, **kw: calls.append(tuple(a[0].shape)) or op(*a, **kw))
    return calls


@pytest.mark.parametrize("kw", [{}, {"qk_norm": False}, {"use_rope": False}],
                         ids=["qk-norm", "rope-only", "no-rope"])
def test_project_qkv_calls_k5_only_without_autograd(monkeypatch, kw):
    """Where K5 takes the tensors, `_project_qkv` calls its op under
    `torch.no_grad()` (once for q and k, and only with RoPE on) and never
    under autograd; both give the plain chain's q, k and v."""
    cfg, _, tp = _attn_setup(seed=3, **kw)
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(5, dtype=torch.int32).expand(2, 5)
    plain = tattn._project_qkv(tp, cfg, x, pos)
    calls = _k5_route_open(monkeypatch)
    with torch.no_grad():
        routed = tattn._project_qkv(tp, cfg, x, pos)
    n = 1 if cfg.use_rope else 0
    assert calls == [tuple(plain[0].shape)] * n
    trained = tattn._project_qkv(tp, cfg, x.clone().requires_grad_(True), pos)
    assert len(calls) == n and trained[0].requires_grad
    for a, b, c in zip(routed, trained, plain):
        assert torch.equal(a, c) and torch.equal(b.detach(), c)


def test_forward_train_gradients_keep_the_plain_chain(monkeypatch):
    """A train step's forward runs under autograd, so an open route to K5
    changes nothing: no call to its op, the same loss and gradients bit for
    bit."""
    cfg = tconfigs.get_smoke("qwen3-8b")
    params = registry.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    leaves = [t for t in torch.utils._pytree.tree_leaves(params) if t.is_floating_point()]
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))

    def grads():
        for t in leaves:
            t.requires_grad_(True)
        out = transformer.forward_train(params, cfg, {"tokens": tokens})
        loss = out["logits"].float().square().mean() + sum(
            z.float().square().mean() for z in out["exit_logits"])
        return [loss.detach()] + list(torch.autograd.grad(loss, leaves))

    want = grads()
    calls = _k5_route_open(monkeypatch)
    got = grads()
    assert calls == []
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ----------------------------------------------------------------- pipeline
def test_token_and_batch_iterators_equal_reference():
    stream = np.random.default_rng(7).integers(0, 500, 5000)
    for tb, jb, _ in zip(tpipe.TokenIterator(stream, 4, 33, seed=3),
                         jpipe.TokenIterator(stream, 4, 33, seed=3), range(5)):
        assert tb.keys() == jb.keys()
        for k in tb:
            assert tb[k].dtype == jb[k].dtype and np.array_equal(tb[k], jb[k])
    arrays = {"x": np.arange(50).reshape(25, 2), "y": np.arange(25)}
    for drop_last in (True, False):
        got = tpipe.BatchIterator(arrays, 4, seed=2, drop_last=drop_last)
        want = jpipe.BatchIterator(arrays, 4, seed=2, drop_last=drop_last)
        for tb, jb, _ in zip(got, want, range(15)):  # crosses an epoch
            for k in arrays:
                assert np.array_equal(tb[k], jb[k])


def test_prefetch_yields_every_batch_in_order_and_places_it():
    arrays = {"x": np.arange(40, dtype=np.float32).reshape(10, 4)}
    batches = list(tpipe.prefetch(iter([{"x": arrays["x"][i:i + 2]} for i in range(0, 10, 2)]),
                                  size=2))
    assert [b["x"][0, 0] for b in batches] == [0.0, 8.0, 16.0, 24.0, 32.0]
    placed = list(tpipe.prefetch(iter([{"x": arrays["x"]}]), device="cpu"))
    assert isinstance(placed[0]["x"], torch.Tensor) and placed[0]["x"].device.type == "cpu"
    assert np.array_equal(placed[0]["x"].numpy(), arrays["x"])


# -------------------------------------------------------------------- scope
@pytest.mark.parametrize("arch,match", [("granite-moe-3b-a800m", "7b"),
                                        ("qwen3-moe-30b-a3b", "7b"),
                                        ("mamba2-130m", "7c"),
                                        ("jamba-v0.1-52b", "7"),
                                        ("whisper-base", "7d")])
def test_unported_families_raise(arch, match):
    """The families ROADMAP.md queue 1 item `match` named as unported no
    longer raise: the registry builds the reference's params tree and
    decode caches (shapes and dtypes) for each."""
    cfg = tconfigs.get_smoke(arch)
    jcfg = jconfigs.get_smoke(arch)
    gen = torch.Generator().manual_seed(0)
    for got, want in ((registry.init_params(gen, cfg, device="cpu"),
                       jax.eval_shape(lambda k: jregistry.init_params(k, jcfg),
                                      jax.random.PRNGKey(0))),
                      (registry.init_cache(cfg, 1, 8, device="cpu"),
                       jax.eval_shape(lambda: jregistry.init_cache(jcfg, 1, 8)))):
        tl = jax.tree.leaves(jax.tree.map(lambda a: a, got,
                                          is_leaf=lambda x: isinstance(x, torch.Tensor)))
        assert [(tuple(t.shape), str(t.dtype)[6:]) for t in tl] == [
            (a.shape, str(a.dtype)) for a in jax.tree.leaves(want)], (arch, match)
