"""Per-architecture smoke tests of the port: the twin of
`tests/test_smoke_archs.py` over all ten LM archs, plus parity.

Each arch's reduced same-family variant (<=2 layers, d_model<=512, <=4
experts) runs, on the CPU, one forward pass, one train step and one
serve step in its own bfloat16, with the output shapes checked and no NaN.
In float32, the port's forward_train is held to the reference's on the
same parameters (the port's seeded init, constant leaves redrawn so that
a mis-wired norm shows, carried to JAX as numpy) within rtol / atol 2e-4,
the LM slice's tolerance: this is the only parity case for chameleon-34b
(the vlm family) and internlm2-20b.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_smoke as jget_smoke
from repro.models import registry as jregistry
from repro_torch.configs import get_smoke, list_archs
from repro_torch.models import convnet, registry, whisper
from repro_torch.training import optim
from repro_torch.training.loop import make_train_step

ARCHS = [a for a in list_archs() if a != "b_alexnet"]
TOL = dict(rtol=2e-4, atol=2e-4)
CPU = torch.device("cpu")


def _params(cfg, seed):
    return registry.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")


def _batch(cfg, b=2, s=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g, dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab_size, (b, s), generator=g, dtype=torch.int32)}
    if cfg.is_encoder_decoder:
        batch["encoder_frames"] = torch.randn(
            (b, cfg.encoder_seq, cfg.d_model), generator=g).to(
            torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
    return batch


def _finite(t):
    return bool(torch.isfinite(t.float()).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_and_nans(arch):
    cfg = get_smoke(arch)
    b, s = 2, 32
    out = registry.forward_train(_params(cfg, 0), cfg, _batch(cfg, b, s))
    assert tuple(out["logits"].shape) == (b, s, cfg.vocab_size)
    assert len(out["exit_logits"]) == len(cfg.exit_layers)
    for ex in out["exit_logits"]:
        assert tuple(ex.shape) == (b, s, cfg.vocab_size)
    assert _finite(out["logits"])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg = get_smoke(arch).replace(dtype="float32")
    rng = np.random.default_rng(1)

    def redraw(t):  # ones -> U(0.5, 1.5), any other constant c -> c + N(0, 0.1^2)
        c = t.flatten()[0].item() if t.numel() else 0
        if t.numel() > 1 and bool((t == c).all()):
            v = rng.uniform(0.5, 1.5, t.shape) if c == 1 else c + rng.normal(0, 0.1, t.shape)
            return torch.as_tensor(v.astype(np.float32))
        return t

    params = pytree.tree_map(redraw, _params(cfg, 0))
    batch = _batch(cfg, seed=3)
    got = registry.forward_train(params, cfg, batch, remat=False)
    jcfg = jget_smoke(arch).replace(dtype="float32")
    want = jax.jit(lambda p, b: jregistry.forward_train(p, jcfg, b, remat=False))(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), params),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    pairs = [(got["logits"], want["logits"])] + list(zip(got["exit_logits"], want["exit_logits"]))
    assert len(pairs) == 1 + len(cfg.exit_layers) == 1 + len(want["exit_logits"])
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step(arch):
    cfg = get_smoke(arch)
    params = _params(cfg, 1)
    before = pytree.tree_map(torch.clone, params)
    step = make_train_step(cfg, optim.AdamWConfig(lr=1e-3, total_steps=10), remat=False,
                           device="cpu")
    params2, state2, metrics = step(params, optim.init(params), _batch(cfg, seed=1))
    assert _finite(metrics["loss"]), metrics
    assert int(state2.step) == 1
    moved = [bool((a.float() != b.float()).any()) for a, b in
             zip(pytree.tree_leaves(before), pytree.tree_leaves(params2))]
    assert any(moved)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_decode_step(arch):
    cfg = get_smoke(arch)
    params = _params(cfg, 2)
    b, L = 2, 64
    caches = registry.init_cache(cfg, b, L, device="cpu")
    if cfg.is_encoder_decoder:
        frames = torch.randn((b, cfg.encoder_seq, cfg.d_model),
                             generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
        caches = {"self": caches["self"],
                  "cross": whisper.prefill_cross_caches(params, cfg, frames)}
    out, _ = registry.decode_step(params, cfg, torch.ones((b, 1), dtype=torch.int32), caches, 3)
    assert tuple(out["logits"].shape) == (b, 1, cfg.vocab_size)
    assert _finite(out["logits"])


def test_b_alexnet_smoke():
    params = convnet.init_params(torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((4, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    out = convnet.forward(params, x)
    assert tuple(out["logits"].shape) == (4, 10)
    assert len(out["exit_logits"]) == 2
    for e in out["exit_logits"]:
        assert tuple(e.shape) == (4, 10) and _finite(e)
