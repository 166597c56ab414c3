"""Port parity for LM training: `repro_torch.training.loop` (loss,
gradients, the train and eval steps) on every LM family against
`repro.training.loop`, on the reference's own seeded parameters carried
across with `params_from_jax`.

One float32 smoke config per family: dense (qwen3-8b at 4 layers, a
stacked segment), moe (granite-moe at 4 layers, a stacked segment),
ssm (mamba2-130m at 4 layers), hybrid (jamba: a mamba layer with a dense
ffn, an attention layer with MoE) and audio (whisper-base); the mamba
layers scan two chunks of 8. The
reference runs under `jax.jit`.

Tolerances: loss and metrics rtol / atol 2e-4, the LM slice's; each
gradient leaf rtol 2e-4 with atol 2e-4 * max|g| of that leaf (a leaf's
small entries are sums of terms as large as its largest, rounded in
another order); a 5-step trajectory's losses rtol 2e-4. Within the port,
checkpointing (remat), unbinding against selecting a stacked segment's
layers, and the in-place update against the functional one are held bit
for bit: each computes the same values in the same order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_smoke as jget_smoke
from repro.models import registry as jregistry
from repro.training import loop as jloop
from repro.training import optim as joptim
from repro_torch.models import transformer
from repro_torch.training import loop as tloop
from repro_torch.training import optim as toptim

TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 16
FAMILIES = {
    "dense": ("qwen3-8b", {"num_layers": 4, "exit_layers": (0, 2),
                           "exit_loss_weights": (1.0, 0.5)}),
    "moe": ("granite-moe-3b-a800m", {"num_layers": 4}),
    "ssm": ("mamba2-130m", {"num_layers": 4, "ssm_chunk": 8}),
    "hybrid": ("jamba-v0.1-52b", {"ssm_chunk": 8}),
    "audio": ("whisper-base", {}),
}


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
def _setup(family):
    arch, kw = FAMILIES[family]
    cfg = jget_smoke(arch).replace(dtype="float32", **kw)
    jparams = _redraw_constants(jregistry.init_params(jax.random.PRNGKey(0), cfg), seed=1)
    return cfg, jparams


def _tparams(jparams):
    return transformer.params_from_jax(jparams, device="cpu")


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    win = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": win[:, :-1], "labels": win[:, 1:]}
    if cfg.is_encoder_decoder:
        out["encoder_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _port_grads(tparams, cfg, batch, remat=True):
    leaves, spec = pytree.tree_flatten(tparams)
    leaves = [p.detach().clone().requires_grad_(True) for p in leaves]
    loss, metrics = tloop.loss_fn(pytree.tree_unflatten(leaves, spec), cfg,
                                  {k: torch.as_tensor(v) for k, v in batch.items()}, remat)
    return loss, metrics, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_metrics_and_gradients_match_reference(family):
    cfg, jparams = _setup(family)
    batch = _batch(cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloop.loss_fn(p, cfg, b, True), has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    tl, tm, tg = _port_grads(_tparams(jparams), cfg, batch)
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), err_msg=k, **TOL)
    if cfg.moe_num_experts:
        assert tm["moe_aux"].item() > 0
    want = pytree.tree_flatten(_tparams(jg))[0]
    assert len(want) == len(tg)
    for path, g, w in zip(pytree.tree_flatten_with_path(_tparams(jg))[0], tg, want):
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * np.abs(w).max(), err_msg=str(path[0]))


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid", "audio"])
def test_remat_gradients_equal_plain_bit_for_bit(family):
    cfg, jparams = _setup(family)
    batch = _batch(cfg, seed=1)
    tparams = _tparams(jparams)
    l1, _, g1 = _port_grads(tparams, cfg, batch, remat=True)
    l0, _, g0 = _port_grads(tparams, cfg, batch, remat=False)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


@pytest.mark.parametrize("family", ["dense", "moe", "ssm"])
def test_unbind_gradients_equal_select_gradients(family, monkeypatch):
    """A stacked segment's layers unbound once (the port) or selected one
    by one (``w[i]``, whose backward adds a zero-padded stack per layer):
    the same loss and gradients, bit for bit."""
    cfg, jparams = _setup(family)
    assert any(n > 1 for _, n, _ in transformer.segment_plan(cfg))
    batch = _batch(cfg, seed=2)
    tparams = _tparams(jparams)
    l1, _, g1 = _port_grads(tparams, cfg, batch)
    monkeypatch.setattr(transformer, "_layers",
                        lambda tree, n: [transformer._layer(tree, i) for i in range(n)])
    l0, _, g0 = _port_grads(tparams, cfg, batch)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


def test_five_step_trajectory_matches_reference():
    """Five AdamW steps of the hybrid (mamba, attention, dense and MoE
    layers): the reference's jitted step against the port's, losses to
    rtol 2e-4; the port's in-place update equals its functional one bit
    for bit and writes into the tensors it was given."""
    cfg, jparams = _setup("hybrid")
    kw = dict(lr=2e-3, warmup_steps=2, total_steps=5)
    jstep = jax.jit(jloop.make_train_step(cfg, joptim.AdamWConfig(**kw), remat=True))
    tstep = tloop.make_train_step(cfg, toptim.AdamWConfig(**kw), device="cpu")
    istep = tloop.make_train_step(cfg, toptim.AdamWConfig(**kw), device="cpu", inplace=True)
    jp, tp, ip = jparams, _tparams(jparams), _tparams(jparams)
    js, ts, is_ = joptim.init(jp), toptim.init(tp), toptim.init(ip)
    ptr = [a.data_ptr() for a in pytree.tree_leaves((ip, is_.mu, is_.nu))]
    jl, tl = [], []
    for i in range(5):
        b = _batch(cfg, seed=100 + i)
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        tp, ts, tm = tstep(tp, ts, b)
        ip, is_, im = istep(ip, is_, b)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        assert float(tm["lr"]) == float(jm["lr"])
        assert torch.equal(im["loss"], tm["loss"])
    np.testing.assert_allclose(tl, jl, rtol=TOL["rtol"])
    assert tl[-1] < tl[0]
    assert all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves((ip, is_)),
                                                 pytree.tree_leaves((tp, ts))))
    assert [a.data_ptr() for a in pytree.tree_leaves((ip, is_.mu, is_.nu))] == ptr


@pytest.mark.parametrize("family", ["ssm", "audio"])
def test_eval_step_matches_reference(family):
    cfg, jparams = _setup(family)
    batch = _batch(cfg, seed=3)
    want = jax.jit(jloop.make_eval_step(cfg))(jparams, jax.tree.map(jnp.asarray, batch))
    got = tloop.make_eval_step(cfg, device="cpu")(_tparams(jparams), batch)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), **TOL)
    for g, w in zip(got["exit_logits"], want["exit_logits"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert not got["logits"].requires_grad
