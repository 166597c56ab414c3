"""Port parity for training (`repro_torch.training`): the joint loss and
its gradients, the AdamW update on shared gradients, the schedule, a
short train trajectory and the eval step, against `repro.training` on
the CPU. Weights come from numpy and are carried across with
`convnet.params_from_jax`.

Tolerances:
* loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-6 (float32 convolutions
  and their backward summed in another order);
* the optimizer fed identical gradients: params and both moments rtol
  1e-6 (the same elementwise float32 arithmetic; the global norm is a
  sum taken in another order), params also atol 1e-8: a weight that the
  step brings near 0 keeps the rounding of the step lr * delta (one
  float32 ulp of 1e-2 is 9.3e-10), not its own, and the first moment
  atol 1e-9 for the same reason: where b1 * mu + (1 - b1) * g cancels
  near 0 it keeps the rounding of its terms (about 2e-4 here, ulp
  1.5e-11, over three steps; XLA may also contract it into one FMA);
* the schedule at steps 0, 1, warmup and total: exact in float32;
* a 5-step loss trajectory: rtol 1e-5 (2.3e-7 measured on the CPU with
  1 to 8 threads). Adam's first steps move every weight by about lr
  whatever the size of its gradient, so a gradient that is about 0 in
  both stacks could take opposite signs and move a weight 2*lr apart;
  these seeded draws keep clear of that, which is why the gradients and
  the optimizer are also held apart, each to its own tolerance;
* eval logits rtol 1e-4 / atol 1e-5, as the forward parity.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import convnet as jconv
from repro.models.convnet import B_ALEXNET as J_ALEXNET
from repro.training import loop as jloop
from repro.training import losses as jlosses
from repro.training import optim as joptim
from repro_torch.configs.base import ModelConfig
from repro_torch.models import convnet as tconv
from repro_torch.models.convnet import B_ALEXNET as T_ALEXNET
from repro_torch.training import loop as tloop
from repro_torch.training import losses as tlosses
from repro_torch.training import optim as toptim

BATCH = 8


def numpy_tree(seed=0, scale=1.0):
    """A reference-shaped parameter tree drawn with numpy: N(0, 1/fan_in)
    weights and small nonzero biases."""
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        fan_in = np.prod(node.shape[:-1]) if len(node.shape) > 1 else 100.0
        return (scale * rng.standard_normal(node.shape) / np.sqrt(fan_in)).astype(np.float32)

    return draw(jax.eval_shape(jconv.init_params, jax.random.PRNGKey(0)))


def batch(seed=0, n=BATCH):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, n).astype(np.int32)}


def to_torch(tree):
    return tconv.params_from_jax(tree, device="cpu")


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_tree_close(t_tree, j_tree, **tol):
    """Compare a port tree with a reference tree (HWIO carried to OIHW)."""
    want = to_torch(jax.tree.map(np.asarray, j_tree))
    for (path, a), (_, b) in zip(
        sorted(torch.utils._pytree.tree_leaves_with_path(t_tree), key=lambda x: str(x[0])),
        sorted(torch.utils._pytree.tree_leaves_with_path(want), key=lambda x: str(x[0])),
    ):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), err_msg=str(path), **tol)


# ------------------------------------------------------------------ losses
def test_softmax_xent_and_multi_exit_loss_match_reference():
    rng = np.random.default_rng(1)
    y = rng.integers(0, 10, 16).astype(np.int32)
    outs = {"logits": rng.standard_normal((16, 10)).astype(np.float32) * 3,
            "exit_logits": [rng.standard_normal((16, 10)).astype(np.float32) for _ in range(2)],
            "moe_aux_loss": np.float32(0.37)}
    jl, jm = jlosses.multi_exit_loss(jax.tree.map(jnp.asarray, outs), jnp.asarray(y), (1.0, 0.5))
    tl, tm = tlosses.multi_exit_loss(jax.tree.map(torch.as_tensor, outs), torch.as_tensor(y),
                                     (1.0, 0.5))
    assert sorted(jm) == sorted(tm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)


def test_loss_and_gradients_match_reference():
    tree, b = numpy_tree(), batch()
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloop.loss_fn, has_aux=True),
                           static_argnums=(1, 3))(
        to_jax(tree), J_ALEXNET, jax.tree.map(jnp.asarray, b), False)
    tparams = to_torch(tree)
    leaves, spec = torch.utils._pytree.tree_flatten(tparams)
    leaves = [p.requires_grad_(True) for p in leaves]
    tl, tm = tloop.loss_fn(torch.utils._pytree.tree_unflatten(leaves, spec), T_ALEXNET,
                           jax.tree.map(torch.as_tensor, b))
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k in ("loss_final", "loss_exit0", "loss_exit1"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
    assert_tree_close(torch.utils._pytree.tree_unflatten(list(tg), spec), jg,
                      rtol=1e-4, atol=1e-6)


def test_other_families_wait_for_the_lm_slice():
    """The LM families no longer wait: their loss is the registry's
    forward through `multi_exit_loss` (the LM slice ports it; held to the
    reference in tests/test_torch_lm_train.py)."""
    from repro_torch.models import registry

    cfg = ModelConfig(name="t", family="dense", num_layers=1, d_model=8, num_heads=1,
                      num_kv_heads=1, d_ff=8, vocab_size=10, head_dim=8)
    params = registry.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    b = {"tokens": torch.as_tensor(rng.integers(0, 10, (2, 4))),
         "labels": torch.as_tensor(rng.integers(0, 10, (2, 4)))}
    loss, metrics = tloop.loss_fn(params, cfg, b)
    want, _ = tlosses.multi_exit_loss(registry.forward_train(params, cfg, b), b["labels"], ())
    assert torch.equal(loss, want) and sorted(metrics) == ["loss", "loss_final", "moe_aux"]


# -------------------------------------------------------------- optimizer
@pytest.mark.parametrize("step", ["0", "1", "warmup", "total"])
def test_schedule_is_exact_at_its_corners(step):
    cfg = toptim.AdamWConfig(lr=2e-3, warmup_steps=200, total_steps=1050)
    jcfg = joptim.AdamWConfig(lr=2e-3, warmup_steps=200, total_steps=1050)
    s = {"0": 0, "1": 1, "warmup": 200, "total": 1050}[step]
    got = toptim.schedule(cfg, torch.tensor(s, dtype=torch.int32))
    want = joptim.schedule(jcfg, jnp.asarray(s, jnp.int32))
    assert got.dtype == torch.float32
    assert got.numpy() == np.asarray(want), (float(got), float(want))


def test_schedule_follows_reference_between_corners():
    cfg = toptim.AdamWConfig(lr=2e-3, warmup_steps=200, total_steps=1050)
    jcfg = joptim.AdamWConfig(lr=2e-3, warmup_steps=200, total_steps=1050)
    steps = np.arange(0, 1100, 7, dtype=np.int32)
    got = toptim.schedule(cfg, torch.as_tensor(steps)).numpy()
    want = np.asarray(joptim.schedule(jcfg, jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("clip_norm", [1e-3, 1e6], ids=["clipped", "unclipped"])
def test_update_on_shared_gradients_matches_reference(clip_norm):
    """Three updates fed the same numpy gradients in both stacks."""
    kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=clip_norm, warmup_steps=2, total_steps=10)
    tcfg, jcfg = toptim.AdamWConfig(**kw), joptim.AdamWConfig(**kw)
    tree = numpy_tree(0)
    jp, tp = to_jax(tree), to_torch(tree)
    js, ts = joptim.init(jp), toptim.init(tp)
    jupdate = jax.jit(joptim.update, static_argnums=0)
    for i in range(3):
        g = numpy_tree(10 + i, scale=0.05)
        jp, js, jm = jupdate(jcfg, jp, to_jax(g), js)
        tp, ts, tm = toptim.update(tcfg, tp, to_torch(g), ts)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == float(jm["lr"])
    assert int(ts.step) == int(js.step) == 3
    assert_tree_close(tp, jp, rtol=1e-6, atol=1e-8)
    assert_tree_close(ts.mu, js.mu, rtol=1e-6, atol=1e-9)
    assert_tree_close(ts.nu, js.nu, rtol=1e-6, atol=1e-15)


def test_weight_decay_skips_vectors():
    cfg = toptim.AdamWConfig(lr=1.0, weight_decay=0.5, warmup_steps=0, total_steps=1,
                             min_lr_frac=1.0)
    params = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    zeros = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    new, _, _ = toptim.update(cfg, params, zeros, toptim.init(params))
    assert torch.equal(new["w"], torch.full((2, 2), 0.5)) and torch.equal(new["b"], torch.ones(2))


# ------------------------------------------------------------- the steps
def test_train_step_trajectory_matches_reference():
    kw = dict(lr=2e-3, weight_decay=0.0, warmup_steps=2, total_steps=5)
    jstep = jax.jit(jloop.make_train_step(J_ALEXNET, joptim.AdamWConfig(**kw), remat=False))
    tstep = tloop.make_train_step(T_ALEXNET, toptim.AdamWConfig(**kw), device="cpu")
    tree = numpy_tree(3)
    jp, tp = to_jax(tree), to_torch(tree)
    js, ts = joptim.init(jp), toptim.init(tp)
    jl, tl = [], []
    for i in range(5):
        b = batch(100 + i)
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        tp, ts, tm = tstep(tp, ts, b)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        assert float(tm["lr"]) == float(jm["lr"])
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)  # before any update
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_eval_step_matches_reference():
    tree, b = numpy_tree(4), batch(7, n=6)
    jout = jloop.make_eval_step(J_ALEXNET)(to_jax(tree), {"images": jnp.asarray(b["images"])})
    tout = tloop.make_eval_step(T_ALEXNET, device="cpu")(to_torch(tree), {"images": b["images"]})
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]),
                               rtol=1e-4, atol=1e-5)
    for a, w in zip(tout["exit_logits"], jout["exit_logits"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_inplace_update_in_slices_is_the_functional_update(monkeypatch):
    """The in-place AdamW update takes a leaf a slice of its first dim at a
    time (`optim.INPLACE_SLICE` elements): bit for bit the functional
    update's params and moments, for 3-d, 2-d, 1-d and 0-d leaves, bf16
    and float32, with weight decay on the matrices only."""
    import torch.utils._pytree as tpytree

    from repro_torch.training import optim as topt

    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(10, 7, 3, generator=g), "b": torch.randn(5, generator=g).bfloat16(),
              "c": torch.randn((), generator=g),
              "d": torch.randn(9, 4, generator=g).bfloat16()}
    grads = tpytree.tree_map(lambda x: torch.randn(x.shape, generator=g).to(x.dtype), params)
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1)
    state = topt.init(params)
    state = state._replace(mu=tpytree.tree_map(lambda x: torch.randn(x.shape, generator=g),
                                               state.mu))
    want = topt.update(cfg, params, grads, state)
    monkeypatch.setattr(topt, "INPLACE_SLICE", 8)  # 10 x 21 in slices of one row
    copy = tpytree.tree_map(torch.clone, (params, state.mu, state.nu))
    got = topt.update(cfg, copy[0], grads, topt.OptState(state.step, copy[1], copy[2]),
                      inplace=True)
    assert got[0]["a"] is copy[0]["a"]  # in place
    for a, b in zip(tpytree.tree_leaves((want[0], want[1].mu, want[1].nu)),
                    tpytree.tree_leaves((got[0], got[1].mu, got[1].nu))):
        assert a.dtype == b.dtype and torch.equal(a, b)
