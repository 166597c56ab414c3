"""Port parity for the rest of the model zoo: `repro_torch.models.moe`,
`models.mamba`, the moe / ssm / hybrid layer kinds of
`models.transformer` and the encoder-decoder `models.whisper`, against
`repro` on the reference's own seeded parameters, carried across with
`params_from_jax`.

Float32 smoke configs of granite-moe-3b-a800m (40 -> 4 experts, top-2),
qwen3-moe-30b-a3b (qk-norm, top-2), mamba2-130m, jamba-v0.1-52b (mamba
and attention layers, MoE on odd layers) and whisper-base, plus 4-layer
variants whose stacked segments take the per-layer loops. The reference
runs under `jax.jit` with the config closed over. Tolerance rtol / atol
2e-4, the LM slice's (`tests/test_torch_lm_model.py`). Norm scales,
biases and the other constant leaves are redrawn so a mis-wired one
shows. The router logits are distinct draws: `torch.topk` and
`lax.top_k` may order tied values differently. The MoE drop decisions
are held exactly (the dropped count; the reference's float32 mean of the
kept mask is off by an ulp at times).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import mamba as jmb
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models import whisper as jwh
from repro_torch.models import mamba, moe, registry, transformer, whisper

TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 16
CASES = {
    "granite": ("granite-moe-3b-a800m", {}),
    "qwen3-moe": ("qwen3-moe-30b-a3b", {}),
    "mamba2": ("mamba2-130m", {}),
    "jamba": ("jamba-v0.1-52b", {}),
    "whisper": ("whisper-base", {}),
    # [L0 exit] [L1-3 stacked]; the SSD scan over two chunks of 8
    "granite-4L": ("granite-moe-3b-a800m", {"num_layers": 4}),
    "mamba2-4L": ("mamba2-130m", {"num_layers": 4, "ssm_chunk": 8}),
    # attention at odd layers, MoE at odd layers: (mamba,dense) (attn,moe) x 2
    "jamba-4L": ("jamba-v0.1-52b", {"num_layers": 4, "exit_layers": (0, 2), "ssm_chunk": 8}),
}
# 2-layer smoke configs whose params are their 4-layer variant's first
# two layers (the same tree shapes)
DERIVED = {"granite": "granite-4L", "mamba2": "mamba2-4L"}
# enough capacity that no (token, slot) is dropped: decode (T = b) and the
# full sequence (T = b * s) then route alike
NO_DROP = {"moe_capacity_factor": 8.0}


def _cfg(name, **kw):
    arch, base = CASES[name]
    return jget_smoke(arch).replace(dtype="float32", **base, **kw)


def _redraw_constants(tree, seed):
    """Constant leaves -> random: ones -> U(0.5, 1.5), any other value c
    (zeros; mamba's dt_bias) -> c + N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def redraw(a):
        a = np.asarray(a)
        c = a.flat[0] if a.size else 0
        if a.size > 1 and np.all(a == c):
            v = rng.uniform(0.5, 1.5, a.shape) if c == 1 else c + rng.normal(0, 0.1, a.shape)
            return jnp.asarray(v.astype(np.float32)).astype(a.dtype)
        return jnp.asarray(a)

    return jax.tree.map(redraw, tree)


@functools.lru_cache(maxsize=None)
def _jparams(name):
    """The reference's seeded params, constants redrawn. A 2-layer smoke
    config whose 4-layer variant is here takes that variant's embedding,
    layer 0, layer 1 (the first of its stacked segment) and heads: the
    reference's eager init compiles each draw's shape anew, seconds a
    config."""
    if name in DERIVED:
        big = _jparams(DERIVED[name])
        return dict(big, segments=[big["segments"][0],
                                   jax.tree.map(lambda a: a[0], big["segments"][1])])
    return _redraw_constants(jregistry.init_params(jax.random.PRNGKey(0), _cfg(name)), seed=1)


@functools.lru_cache(maxsize=None)
def _setup(name, no_drop=False):
    cfg = _cfg(name, **(NO_DROP if no_drop else {}))
    jparams = _jparams(name)
    return cfg, jparams, transformer.params_from_jax(jparams, device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def _batch(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["encoder_frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ----------------------------------------------------------------------- moe
def _moe_params(cfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), cfg)
    return jp, transformer.params_from_jax(jp, device="cpu")


def _moe_pair(cfg, jp, tp, x):
    jy, jaux = jax.jit(lambda p, x: jmoe.apply_moe(p, cfg, x))(jp, jnp.asarray(x))
    ty, taux = moe.apply_moe(tp, cfg, torch.from_numpy(x))
    return (ty, taux), (jy, jaux)


@pytest.mark.parametrize("arch,shape", [("granite-moe-3b-a800m", (4, 16)),
                                        ("granite-moe-3b-a800m", (2, 1)),
                                        ("qwen3-moe-30b-a3b", (4, 16)),
                                        ("qwen3-moe-30b-a3b", (3, 5))])
def test_apply_moe_matches_reference(arch, shape):
    """y, the aux loss and the dropped share; (4, 16) tokens at capacity
    factor 0.5 drop some (token, slot) pairs."""
    cfg = jget_smoke(arch).replace(dtype="float32")
    if shape == (4, 16):
        cfg = cfg.replace(moe_capacity_factor=0.5)
    jp, tp = _moe_params(cfg)
    x = _x(shape + (cfg.d_model,), seed=1)
    (ty, taux), (jy, jaux) = _moe_pair(cfg, jp, tp, x)
    assert tuple(ty.shape) == x.shape
    _close(ty, jy)
    _close(taux["moe_aux_loss"], jaux["moe_aux_loss"])
    pairs = x.size // cfg.d_model * cfg.moe_top_k
    assert (round(float(taux["moe_dropped_frac"]) * pairs)
            == round(float(jaux["moe_dropped_frac"]) * pairs))
    assert abs(float(taux["moe_dropped_frac"]) - float(jaux["moe_dropped_frac"])) <= 1e-6
    assert float(taux["moe_aux_loss"]) >= 1.0 - 1e-3  # >= 1 by Cauchy-Schwarz
    if shape == (4, 16):
        assert float(taux["moe_dropped_frac"]) > 0.0


def test_moe_capacity_and_alloc_match_reference():
    for arch in ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b", "jamba-v0.1-52b"):
        for pad in (False, True):
            from repro.configs import get_config as jget_config

            cfg = jget_config(arch).replace(moe_shard_capacity=pad)
            assert moe.n_alloc_experts(cfg) == jmoe.n_alloc_experts(cfg)
            for t in (1, 2, 7, 64, 4096):
                assert moe.moe_capacity(cfg, t) == jmoe.moe_capacity(cfg, t)


def test_moe_padded_experts_never_win():
    """The shard-friendly variant (6 experts padded to 16, the padded
    weights zero): the same y as the unpadded layer in both packages, and
    equal to the reference's padded run."""
    cfg = jget_smoke("granite-moe-3b-a800m").replace(
        dtype="float32", moe_num_experts=6, moe_top_k=2, moe_capacity_factor=8.0)
    cfg_p = cfg.replace(moe_shard_capacity=True)
    jp, _ = _moe_params(cfg)
    pad = jmoe.n_alloc_experts(cfg_p) - cfg.moe_num_experts
    assert pad == 10
    jp_pad = {k: jnp.pad(v, ((0, pad), (0, 0), (0, 0))) if k != "router" else v
              for k, v in jp.items()}
    tp_pad = transformer.params_from_jax(jp_pad, device="cpu")
    tp = transformer.params_from_jax(jp, device="cpu")
    x = _x((4, 8, cfg.d_model), seed=2)
    (ty_pad, taux), (jy_pad, jaux) = _moe_pair(cfg_p, jp_pad, tp_pad, x)
    ty, _ = moe.apply_moe(tp, cfg, torch.from_numpy(x))
    _close(ty_pad, jy_pad)
    np.testing.assert_allclose(ty_pad.numpy(), ty.numpy(), atol=1e-5)
    assert float(taux["moe_dropped_frac"]) == float(jaux["moe_dropped_frac"]) == 0.0


def test_moe_zero_router_is_uniform_mixture():
    """With identical experts (and a zero router: every gate ties), the
    layer is that one expert's MLP, whichever experts top-k picks."""
    cfg = jget_smoke("granite-moe-3b-a800m").replace(dtype="float32",
                                                    moe_capacity_factor=10.0)
    jp, _ = _moe_params(cfg, seed=4)
    jp = {k: (jnp.broadcast_to(v[:1], v.shape) if k != "router" else jnp.zeros_like(v))
          for k, v in jp.items()}
    tp = transformer.params_from_jax(jp, device="cpu")
    x = _x((2, 4, cfg.d_model), seed=4)
    ty, _ = moe.apply_moe(tp, cfg, torch.from_numpy(x))
    jy, _ = jax.jit(lambda p, x: jmoe.apply_moe(p, cfg, x))(jp, jnp.asarray(x))
    w = {k: np.asarray(v[0]) for k, v in jp.items() if k != "router"}
    up = x @ w["w_gate"]
    ref = ((up / (1 + np.exp(-up))) * (x @ w["w_up"])) @ w["w_down"]
    np.testing.assert_allclose(ty.numpy(), ref, rtol=1e-3, atol=1e-3)
    _close(ty, jy)


# --------------------------------------------------------------------- mamba
def _ssd_inputs(seed=0, b=2, s=32, h=4, p=8, g=2, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    B_ = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C_ = rng.standard_normal((b, s, g, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    return x, dt, A, B_, C_, D


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_matches_reference_and_recurrence(chunk):
    args = _ssd_inputs()
    ty, tS = mamba.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk)
    jy, jS = jax.jit(jmb.ssd_chunked, static_argnums=6)(*map(jnp.asarray, args), chunk)
    _close(ty, jy)
    _close(tS, jS)
    # the O(s) per-step recurrence
    x, dt, A, B_, C_, D = args
    hg = x.shape[2] // B_.shape[2]
    Bh, Ch = np.repeat(B_, hg, axis=2), np.repeat(C_, hg, axis=2)
    S_ = np.zeros((x.shape[0], x.shape[2], x.shape[3], B_.shape[3]), np.float64)
    ys = []
    for t in range(x.shape[1]):
        S_ = S_ * np.exp(-dt[:, t] * A)[:, :, None, None] + np.einsum(
            "bh,bhn,bhp->bhpn", dt[:, t], Bh[:, t], x[:, t])
        ys.append(np.einsum("bhn,bhpn->bhp", Ch[:, t], S_) + x[:, t] * D[None, :, None])
    np.testing.assert_allclose(ty.numpy(), np.stack(ys, 1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tS.numpy(), S_, rtol=1e-4, atol=1e-4)


def test_ssd_chunked_gradient_stays_finite_where_the_decay_overflows():
    """dt large enough that exp(cs_i - cs_j) above the diagonal overflows
    float32: the forward equals the reference's, and the port's gradient
    is finite (the reference's where(causal, exp(-seg), 0) gives NaN
    there: 0 * inf in its backward)."""
    x, dt, A, B_, C_, D = _ssd_inputs(seed=3)
    dt = dt * 60.0
    ty, _ = mamba.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B_, C_, D)), chunk=32)
    jy, _ = jax.jit(jmb.ssd_chunked, static_argnums=6)(*map(jnp.asarray, (x, dt, A, B_, C_, D)),
                                                       32)
    _close(ty, jy)
    tdt = torch.from_numpy(dt).requires_grad_(True)
    y, S_ = mamba.ssd_chunked(torch.from_numpy(x), tdt, *map(torch.from_numpy, (A, B_, C_, D)),
                              chunk=32)
    (y.sum() + S_.sum()).backward()
    assert torch.isfinite(tdt.grad).all()


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
def test_mamba_prefill_and_decode_match_reference(split):
    """Both projection layouts: prefill's output and cache, then decode
    steps from that cache, each against the reference's."""
    cfg = jget_smoke("mamba2-130m").replace(dtype="float32", mamba_split_proj=split)
    jp = _redraw_constants(jmb.init_mamba(jax.random.PRNGKey(5), cfg), seed=5)
    tp = transformer.params_from_jax(jp, device="cpu")
    x = _x((B, S, cfg.d_model), seed=6)
    jout, jc = jax.jit(lambda p, x: jmb.mamba_prefill(p, cfg, x))(jp, jnp.asarray(x))
    tout, tc = mamba.mamba_prefill(tp, cfg, torch.from_numpy(x))
    _close(tout, jout)
    _close(tc["conv"], jc["conv"])
    _close(tc["ssd"], jc["ssd"])
    jstep = jax.jit(lambda p, x, c: jmb.mamba_decode(p, cfg, x, c))
    for t in range(4):
        xt = _x((B, 1, cfg.d_model), seed=10 + t)
        jo, jc = jstep(jp, jnp.asarray(xt), jc)
        to, tc2 = mamba.mamba_decode(tp, cfg, torch.from_numpy(xt), tc)
        assert tc2 is tc  # updated in place
        _close(to, jo)
        _close(tc["conv"], jc["conv"])
        _close(tc["ssd"], jc["ssd"])
    c0 = mamba.init_mamba_cache(cfg, B, "cpu")
    j0 = jmb.init_mamba_cache(cfg, B)
    for k in ("conv", "ssd"):
        assert tuple(c0[k].shape) == j0[k].shape and str(c0[k].dtype)[6:] == str(j0[k].dtype)


# ------------------------------------------------------------- whole models
def _jmod(cfg):
    return jwh if cfg.is_encoder_decoder else jregistry


FAMILIES = ["granite", "qwen3-moe", "mamba2", "jamba", "whisper", "granite-4L", "mamba2-4L",
            "jamba-4L"]


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_train_and_prefill_match_reference(name):
    cfg, jparams, tparams = _setup(name)
    batch = _batch(cfg)
    mod = _jmod(cfg)
    want, want_prefill = jax.jit(lambda p, b: (mod.forward_train(p, cfg, b, remat=False),
                                               mod.forward_prefill(p, cfg, b)))(
        jparams, jax.tree.map(jnp.asarray, batch))
    got = registry.forward_train(tparams, cfg, batch)
    _close(got["logits"], want["logits"])
    assert len(got["exit_logits"]) == len(want["exit_logits"]) == len(cfg.exit_layers)
    for g, w in zip(got["exit_logits"], want["exit_logits"]):
        _close(g, w)
    _close(got["moe_aux_loss"], want["moe_aux_loss"])
    if cfg.moe_num_experts:
        assert float(got["moe_aux_loss"]) > 0.0

    want = want_prefill
    got = registry.forward_prefill(tparams, cfg, batch)
    _close(got["logits"], want["logits"])
    for g, w in zip(got["exit_logits"], want["exit_logits"]):
        _close(g, w)
    gl = [l for l in jax.tree.leaves(jax.tree.map(lambda a: a, got["caches"],
                                                  is_leaf=lambda x: isinstance(x, torch.Tensor)))]
    wl = jax.tree.leaves(want["caches"])
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        _close(g, w)


@pytest.mark.parametrize("name,unroll", [(n, False) for n in ("granite", "qwen3-moe", "mamba2",
                                                                "jamba", "whisper", "granite-4L",
                                                                "mamba2-4L", "jamba-4L")]
                         + [("granite-4L", True), ("mamba2-4L", True)])
def test_decode_step_matches_reference(name, unroll):
    """Decode token by token from a fresh cache (whisper's cross caches
    from prefill_cross_caches), against the reference, and against the
    port's own forward_train (ample MoE capacity, so that a one-token step
    and the whole sequence drop nothing). `decode_unroll` changes only a
    stacked segment's decode, so it runs on the two configs that have
    one."""
    cfg, jparams, tparams = _setup(name, no_drop=True)
    cfg = cfg.replace(decode_unroll=unroll)
    batch = _batch(cfg, seed=1)
    toks = batch["tokens"]
    jstep = jax.jit(lambda p, t, c, pos: _jmod(cfg).decode_step(p, cfg, t, c, pos))
    if cfg.is_encoder_decoder:
        jc = jwh.init_cache(cfg, B, S)
        jc["cross"] = jwh.prefill_cross_caches(jparams, cfg, jnp.asarray(batch["encoder_frames"]))
        tc = whisper.init_cache(cfg, B, S, device="cpu")
        tc["cross"] = whisper.prefill_cross_caches(tparams, cfg, batch["encoder_frames"])
        for g, w in zip(tc["cross"], jc["cross"]):
            _close(g["k"], w["k"])
    else:
        jc = jregistry.init_cache(cfg, B, S)
        tc = registry.init_cache(cfg, B, S, device="cpu")
    full = registry.forward_train(tparams, cfg, batch)
    outs = []
    for t in range(S):
        want, jc = jstep(jparams, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        got, tc = registry.decode_step(tparams, cfg, toks[:, t:t + 1], tc, t)
        _close(got["logits"], want["logits"])
        for g, w in zip(got["exit_logits"], want["exit_logits"]):
            _close(g, w)
        outs.append(got["logits"][:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full["logits"].numpy(), **TOL)
    gl = jax.tree.leaves(jax.tree.map(lambda a: a, tc, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    wl = jax.tree.leaves(jc)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        _close(g, w)


@pytest.mark.parametrize("name", ["granite-4L", "mamba2-4L", "jamba-4L", "whisper"])
def test_seeded_init_has_the_reference_tree(name):
    """The port's own seeded init: the reference's tree, shapes and
    dtypes (bf16)."""
    cfg = _cfg(name).replace(dtype="bfloat16")
    tparams = registry.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    jshapes = jax.eval_shape(lambda k: jregistry.init_params(k, cfg), jax.random.PRNGKey(0))
    tl = jax.tree.leaves(jax.tree.map(lambda a: a, tparams,
                                      is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert [(a.shape, str(a.dtype)) for a in jax.tree.leaves(jshapes)] == [
        (tuple(t.shape), str(t.dtype)[6:]) for t in tl]


# bf16 roundings on the path to exit 0 (after layer 0), each passing its
# error on with gain about 1: mamba2 -- norm, in_proj, the conv's four
# products, three adds and bias, the silu cast, y's cast, the gated norm's
# cast, out_proj, residual, exit norm, unembed (17); whisper -- the frames
# and positions, two encoder layers of 12 (norm, q/k/v, scores, probs, PV,
# wo, residual, norm, up, gelu, down, residual) and its final norm, the
# decoder's embedding and positions, self- and cross-attention of 7 each,
# the MLP's 5, exit norm, unembed (48)
BF16_ROUNDINGS = {"mamba2-130m": 17, "whisper-base": 48}


@pytest.mark.parametrize("arch", list(BF16_ROUNDINGS))
def test_bf16_decisions_agree_with_reference(arch):
    """bf16 smoke configs, the reference's weights, 256 sequences: the exit
    logits within BF16_ROUNDINGS[arch] u max|z| of the reference's (u =
    2^-8), and decisions held where the measured gap g cannot flip them,
    as tests/test_torch_lm_model.py derives: predictions where the top-2
    margin exceeds 2 g, exit decisions where |conf - p_tar| exceeds
    conf (exp(2 g / T) - 1), each on at least half the rows."""
    from repro.core.exits import gate_statistics as jgate
    from repro_torch.core.exits import gate_statistics

    cfg = jget_smoke(arch)
    jparams = _redraw_constants(jregistry.init_params(jax.random.PRNGKey(0), cfg), seed=1)
    tparams = transformer.params_from_jax(jparams, device="cpu")
    batch = _batch(cfg, b=256, seed=5)
    jb = jax.tree.map(jnp.asarray, batch)
    if cfg.is_encoder_decoder:
        jb["encoder_frames"] = jb["encoder_frames"].astype(jnp.bfloat16)
        batch["encoder_frames"] = torch.from_numpy(batch["encoder_frames"]).to(torch.bfloat16)
    want = jax.jit(lambda p, b: _jmod(cfg).forward_prefill(p, cfg, b))(jparams, jb)
    got = registry.forward_prefill(tparams, cfg, batch)["exit_logits"][0]
    assert got.dtype == torch.bfloat16
    zj = np.asarray(want["exit_logits"][0][:, 0], np.float32)
    zt = got[:, 0].float().numpy()
    gap = np.abs(zt - zj).max()
    assert gap <= BF16_ROUNDINGS[arch] * 2.0 ** -8 * np.abs(zj).max(), gap
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
