"""Tensor-parallel training on a model axis (`training.loop.make_grad_fn` /
`make_train_step` / `make_eval_step` with a (data, model) ``mesh``,
`launch.mesh`'s autograd collectives, the vocab-parallel
`losses.softmax_xent`, `optim.global_norm` over the model axis, and
`training.checkpoint` over a mesh) against the reference's one-device
``jax.value_and_grad(loss_fn)`` and `train_step`.

Gloo ranks on the CPU, launched once per world size with ``python -m
torch.distributed.run --standalone`` in a subprocess: two ranks as a
(data 1, model 2) mesh and four as (data 2, model 2). Every rank gets the
same global batches and the reference's seeded params (`params_from_jax`
with constant leaves redrawn, so norm scales and biases have teeth) and
keeps its slices; the reference runs the same params on one device under
`jax.jit` while the ranks run. Four float32 smoke configs: qwen3-8b
(qk-norm, a stacked segment, two exits), qwen2-72b with one kv head
(q/k/v biases, GQA: the kv heads stay whole on every rank), granite-moe
(tied embeddings, 4 experts split over the ranks, capacity factor 0.5 so
tokens drop) and chameleon-34b (vlm).

Tolerances, as tests/test_torch_lm_train.py: loss, metrics and
``grad_norm`` rtol / atol 2e-4; every gradient leaf, gathered whole,
rtol 2e-4 with atol 2e-4 * max|g| of the leaf; the parameters after 3
steps rtol / atol 2e-4; the MoE's dropped counts equal to the port's
one-device run; the replicated leaves bit-equal over the ranks; the
checkpoint's leaves bit for bit. AdamW runs at `launch.train`'s learning
rate, 3e-4: Adam turns a gradient element near 0 into an update of up to
the learning rate whatever its rounding, so an element whose gradient
agrees within the gradient tolerance can still move apart by a fraction
of it (at 2e-3 one embedding element of 131 072 ended 2.08e-4 apart).
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_smoke as jget_smoke
from repro.models import registry as jregistry
from repro.training import checkpoint as jcheckpoint
from repro.training import loop as jloop
from repro.training import losses as jlosses
from repro.training import optim as joptim
from repro_torch import sharding
from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import transformer
from repro_torch.training import loop, optim

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = dict(rtol=2e-4, atol=2e-4)
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=5)
B, S, STEPS = 4, 16, 3
WORLDS = {2: (1, 2), 4: (2, 2)}  # ranks -> (data, model)
CONFIGS = {
    # exits after layers 0 and 2 of 4: one-layer segments and a stacked one
    "qwen3": ("qwen3-8b", dict(num_layers=4, exit_layers=(0, 2),
                               exit_loss_weights=(1.0, 0.5))),
    # one kv head: wk / wv / bk / bv whole, q heads split
    "qwen2": ("qwen2-72b", dict(num_kv_heads=1)),
    # E = 4, top-2, C = int(64 * 2 * 0.5 / 4) + 1 = 17 of 32 slots an expert
    "moe": ("granite-moe-3b-a800m", dict(moe_capacity_factor=0.5)),
    "vlm": ("chameleon-34b", {}),
}
XENT_ROWS, XENT_V = 40, 512

WORKER = textwrap.dedent('''
    import os, pickle, sys
    import numpy as np, torch
    import torch.utils._pytree as pytree
    from repro_torch import sharding
    from repro_torch.launch.mesh import gather_whole, join_ranks, record_collectives
    from repro_torch.models import transformer
    from repro_torch.training import checkpoint, loop, losses, optim

    mesh, backend = join_ranks("cpu", model=2)
    with open(sys.argv[1], "rb") as f:
        jobs = pickle.load(f)
    opt = jobs.pop("opt")
    drops = []
    apply_moe = transformer.apply_moe

    def tapped(p, cfg, x):
        y, aux = apply_moe(p, cfg, x)
        drops.append(float(aux["moe_dropped_frac"]))
        return y, aux

    transformer.apply_moe = tapped
    m_idx = mesh.coordinate("model")
    out = {"backend": backend, "coords": (mesh.coordinate("data"), m_idx), "shape": mesh.shape}

    def floats(m):
        return {k: float(v) for k, v in m.items()}

    for name, job in jobs.items():
        if name == "xent":
            z, y = torch.from_numpy(job["z"]), torch.from_numpy(job["labels"])
            V = z.shape[-1]
            n = V // 2
            shard = z[:, m_idx * n:(m_idx + 1) * n].clone().requires_grad_(True)
            with sharding.use_mesh(mesh), record_collectives() as log:
                loss = losses.softmax_xent(shard, y, vocab=V)
                loss.backward()
            out[name] = {"loss": float(loss), "grad": shard.grad.numpy(),
                         "passes": log.by_pass()}
            continue
        cfg = job["cfg"]
        by_path = loop.whole_specs(cfg, mesh)

        def whole(tree):
            specs = sharding.lay_over(tree, by_path)
            return [a.numpy() for a in pytree.tree_leaves(gather_whole(tree, specs, mesh))]

        params = transformer.params_from_jax(job["params"], "cpu", mesh=mesh)
        res = {}
        drops.clear()
        with record_collectives() as log:
            metrics, grads, _ = loop.make_grad_fn(cfg, device="cpu", mesh=mesh)(
                params, job["batches"][0])
        res["metrics"], res["grads"], res["passes"] = floats(metrics), whole(grads), log.by_pass()
        res["drops"] = list(drops)
        ev = loop.make_eval_step(cfg, mesh=mesh)(params, {"tokens": job["batches"][0]["tokens"]})
        res["eval"] = [ev["logits"].numpy()] + [z.numpy() for z in ev["exit_logits"]]
        if name == "qwen3":  # the initial params' checkpoint
            path = f"{sys.argv[2]}.init.msgpack"
            specs = sharding.lay_over(params, by_path)
            checkpoint.save(path, params, mesh, specs)
            torch.distributed.barrier()
            back = checkpoint.load(path, params, mesh, specs)
            res["ckpt_back"] = all(torch.equal(a, b) for a, b in
                                   zip(pytree.tree_leaves(back), pytree.tree_leaves(params)))
            res["ckpt"] = path
        step = loop.make_train_step(cfg, optim.AdamWConfig(**opt), mesh=mesh, inplace=True)
        state = optim.init(params)
        res["steps"] = []
        for b in job["batches"]:
            params, state, m = step(params, state, b)
            res["steps"].append(floats(m))
        res["params"] = whole(params)
        flat = pytree.tree_flatten_with_path(params)[0]
        res["local"] = {sharding.path_str(p): a.numpy() for p, a in flat}
        res["split"] = {sharding.path_str(p): "model" in by_path[sharding.path_str(p)]
                        for p, _ in flat}
        out[name] = res
    with open(f"{sys.argv[2]}.{torch.distributed.get_rank()}", "wb") as f:
        pickle.dump(out, f)
''')


def torchrun(args, nproc, timeout):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc)] + args,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), timeout


def finish(run):
    proc, timeout = run
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"the ranks did not finish in {timeout} s:\n{err[-4000:]}")
    ranks = "\n".join(line for line in err.splitlines() if line.startswith("[rank"))
    assert proc.returncode == 0, (ranks or err)[-4000:]
    return out


def _redraw_constants(tree, seed):
    """Constant leaves -> random: ones -> U(0.5, 1.5), any other c -> c +
    N(0, 0.1^2) (zero biases get teeth)."""
    rng = np.random.default_rng(seed)

    def redraw(a):
        a = np.asarray(a)
        c = a.flat[0] if a.size else 0
        if a.size > 1 and np.all(a == c):
            v = rng.uniform(0.5, 1.5, a.shape) if c == 1 else c + rng.normal(0, 0.1, a.shape)
            return v.astype(np.float32).astype(a.dtype)
        return a

    return jax.tree.map(redraw, tree)


def _jobs():
    jobs, ref = {"opt": OPT}, {}
    for i, (name, (arch, kw)) in enumerate(CONFIGS.items()):
        jcfg = jget_smoke(arch).replace(dtype="float32", **kw)
        jparams = jax.tree.map(np.asarray, _redraw_constants(
            jregistry.init_params(jax.random.PRNGKey(i), jcfg), seed=i))
        rng = np.random.default_rng(10 + i)
        batches = []
        for _ in range(STEPS):
            win = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
            batches.append({"tokens": win[:, :-1], "labels": win[:, 1:]})
        jobs[name] = dict(cfg=get_smoke(arch).replace(dtype="float32", **kw), params=jparams,
                          batches=batches)
        ref[name] = (jcfg, jparams, batches)
    rng = np.random.default_rng(3)
    z = (rng.standard_normal((XENT_ROWS, XENT_V)) * 3).astype(np.float32)
    # labels in both vocab shards, the shards' edges among them
    labels = rng.integers(0, XENT_V, XENT_ROWS).astype(np.int32)
    labels[:4] = [0, XENT_V // 2 - 1, XENT_V // 2, XENT_V - 1]
    jobs["xent"] = ref["xent"] = {"z": z, "labels": labels}
    return jobs, ref


_REF = {}


def _reference(name, ref):
    if name not in _REF:
        _REF[name] = _compute_reference(name, ref[name])
    return _REF[name]


def _compute_reference(name, job):
    if name == "xent":
        z, y = jnp.asarray(job["z"]), jnp.asarray(job["labels"])
        loss, grad = jax.value_and_grad(jlosses.softmax_xent)(z, y)
        return {"loss": float(loss), "grad": np.asarray(grad)}
    cfg, params, batches = job
    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jloop.loss_fn(p, cfg, b, True), has_aux=True))(params, jb[0])
    step = jax.jit(jloop.make_train_step(cfg, joptim.AdamWConfig(**OPT)))
    p, state, steps = params, joptim.init(params), []
    for b in jb:
        p, state, m = step(p, state, b)
        steps.append({k: float(v) for k, v in m.items()})
    ev = jloop.make_eval_step(cfg)(params, {"tokens": jb[0]["tokens"]})
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": [np.asarray(g) for g in _port_leaves(grads)],
            "steps": steps, "params": [np.asarray(a) for a in _port_leaves(p)],
            "eval": [np.asarray(ev["logits"])] + [np.asarray(z) for z in ev["exit_logits"]]}


def _port_leaves(tree):
    """A reference tree's leaves in the port's order (the order
    `params_from_jax` gives the ranks' trees)."""
    return pytree.tree_leaves(transformer.params_from_jax(tree, "cpu"))


def _one_device_drops(name, ref):
    """The port's one-device dropped share per MoE layer on the first
    batch (the forward's calls)."""
    cfg, params, batches = ref[name]
    tcfg = get_smoke(CONFIGS[name][0]).replace(dtype="float32", **CONFIGS[name][1])
    got, tap = [], transformer.apply_moe

    def tapped(p, c, x):
        y, aux = tap(p, c, x)
        got.append(float(aux["moe_dropped_frac"]))
        return y, aux

    transformer.apply_moe = tapped
    try:
        loop.make_grad_fn(tcfg, device="cpu")(transformer.params_from_jax(params, "cpu"),
                                              batches[0])
    finally:
        transformer.apply_moe = tap
    return got


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results for every job at each world size, and the
    reference's inputs."""
    d = tmp_path_factory.mktemp("tp_train")
    jobs, ref = _jobs()
    with open(d / "jobs.pkl", "wb") as f:
        pickle.dump(jobs, f)
    (d / "worker.py").write_text(WORKER)
    runs = {w: torchrun([str(d / "worker.py"), str(d / "jobs.pkl"), str(d / f"out{w}")], w, 300)
            for w in WORLDS}
    for name in ref:  # the reference's runs while the ranks run
        _reference(name, ref)
    outs = {}
    for w, run in runs.items():
        finish(run)
        outs[w] = []
        for r in range(w):
            with open(d / f"out{w}.{r}", "rb") as f:
                outs[w].append(pickle.load(f))
    return outs, ref


def _close_leaves(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"], atol=TOL["atol"] * np.abs(w).max(),
                                   err_msg=f"{what} leaf {i}")


# ------------------------------------------------------------------- tests
def test_mesh_layout(ranks):
    outs, _ = ranks
    for w, (data, model) in WORLDS.items():
        got = sorted(o["coords"] for o in outs[w])
        assert got == [(i, j) for i in range(data) for j in range(model)], got
        assert all(o["backend"] == "gloo" and o["shape"] == (data, model) for o in outs[w])


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_gradients_match_reference(ranks, world, name):
    """The loss, its metrics and every gradient leaf (a split leaf's
    blocks gathered whole) on every rank against the reference's
    ``jax.value_and_grad(loss_fn)`` on one device."""
    outs, ref = ranks
    want = _reference(name, ref)
    for out in outs[world]:
        got = out[name]
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, err_msg=k, **TOL)
        _close_leaves(got["grads"], want["grads"], f"{name} grads")
    split = outs[world][0][name]["split"]
    assert any(split.values()) and not all(split.values())


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_steps_match_reference(ranks, world, name):
    """Three AdamW steps (remat, the in-place update): every step's losses,
    ``grad_norm`` and learning rate, and the parameters after them,
    gathered whole, against the reference's jitted `train_step`."""
    outs, ref = ranks
    want = _reference(name, ref)
    assert want["steps"][0]["grad_norm"] > OPT.get("clip_norm", 1.0)  # the clip acts
    for out in outs[world]:
        got = out[name]
        for t, (g, w) in enumerate(zip(got["steps"], want["steps"])):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], err_msg=f"step {t} {k}", **TOL)
        assert len(got["params"]) == len(want["params"])
        for i, (g, w) in enumerate(zip(got["params"], want["params"])):
            np.testing.assert_allclose(g, w, err_msg=f"{name} param {i}", **TOL)


@pytest.mark.parametrize("world", list(WORLDS))
def test_replicated_leaves_bit_equal_over_ranks(ranks, world):
    """After the steps every replicated leaf is the same bit for bit on
    every rank, and a split leaf's block is the same on the data ranks
    that share a model coordinate."""
    outs, _ = ranks
    for name in CONFIGS:
        first = outs[world][0][name]
        n_rep = 0
        for path, is_split in first["split"].items():
            for out in outs[world][1:]:
                if not is_split:
                    np.testing.assert_array_equal(out[name]["local"][path], first["local"][path],
                                                  err_msg=f"{name} {path}")
                elif out["coords"][1] == outs[world][0]["coords"][1]:
                    np.testing.assert_array_equal(out[name]["local"][path], first["local"][path],
                                                  err_msg=f"{name} {path}")
            n_rep += not is_split
        assert n_rep > 0


@pytest.mark.parametrize("world", list(WORLDS))
def test_moe_dropped_counts_equal_one_device(ranks, world):
    outs, ref = ranks
    cfg = ref["moe"][0]
    one = _one_device_drops("moe", ref)
    slots = B * S * cfg.moe_top_k
    assert sum(round(v * slots) for v in one) > 0  # tokens drop
    for out in outs[world]:
        assert [round(v * slots) for v in out["moe"]["drops"]] == [round(v * slots) for v in one]


@pytest.mark.parametrize("world", list(WORLDS))
def test_vocab_parallel_xent_matches_reference(ranks, world):
    """The vocab-parallel loss on each rank's half of the logits, labels in
    both halves, against the reference's `softmax_xent` on whole rows; its
    gradient is this rank's slice of the reference's, and only the
    forward issues collectives (the maxima's gather and one all-reduce of
    the sums and the labels' logits)."""
    outs, ref = ranks
    want = _reference("xent", ref)
    n = XENT_V // 2
    for out in outs[world]:
        got, m = out["xent"], out["coords"][1]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["grad"], want["grad"][:, m * n:(m + 1) * n],
                                   rtol=1e-5, atol=1e-7)
        assert got["passes"] == {"forward": {
            "counts": {"all-reduce": 2},
            "bytes": {"all-reduce": 2 * XENT_ROWS * 4 + 2 * XENT_ROWS * 4}}}


@pytest.mark.parametrize("world", list(WORLDS))
def test_eval_step_returns_whole_vocab_logits(ranks, world):
    """`make_eval_step(mesh=)` on every rank: the final and exit logits
    over the whole vocabulary and the whole batch, as the reference's
    eval step gives them."""
    outs, ref = ranks
    for name in CONFIGS:
        want = _reference(name, ref)["eval"]
        for out in outs[world]:
            for g, w in zip(out[name]["eval"], want):
                assert g.shape == w.shape == (B, S, ref[name][0].vocab_size)
                np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("world", list(WORLDS))
def test_mesh_checkpoint_is_the_reference_file(ranks, world):
    """The ranks' checkpoint of their slices, written by rank 0, loads in
    the reference's `checkpoint.load` as the one-device params bit for
    bit, and each rank's mesh load gives back its own slices."""
    outs, ref = ranks
    _, jparams, _ = ref["qwen3"]
    got = outs[world][0]["qwen3"]
    loaded = jcheckpoint.load(got["ckpt"], jparams)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert all(out["qwen3"]["ckpt_back"] for out in outs[world])


def test_collectives_of_a_step_by_pass(ranks):
    """The qwen2 smoke's step at (1, 2), worked out by hand. Forward: the
    embedding's all-reduce, two row-parallel reduces a layer, two a head
    for the vocab-parallel loss (the maxima, the sums); backward: one a
    layer for the attention's q input, two for its whole k and v, one for
    the MLP's input, one a head; the recompute of the checkpointed
    layers reruns the attention's reduce, which the MLP's saved inputs
    need (the MLP's own reduce feeds nothing saved: the recompute stops
    before it)."""
    outs, ref = ranks
    cfg = ref["qwen2"][0]
    L, heads = cfg.num_layers, 1 + len(cfg.exit_layers)
    passes = outs[2][0]["qwen2"]["passes"]
    assert passes["forward"]["counts"] == {"all-reduce": 1 + 2 * L + 2 * heads}
    assert passes["backward"]["counts"] == {"all-reduce": 4 * L + heads}
    assert passes["recompute"]["counts"] == {"all-reduce": L}
    rows, d = B * S, cfg.d_model
    kv = cfg.num_kv_heads * cfg.head_dim
    assert passes["backward"]["bytes"] == {
        "all-reduce": 4 * rows * (L * (2 * d + 2 * kv) + heads * d)}


def test_train_step_refuses_the_other_families_on_a_model_axis():
    """No family is refused on a model axis: the encoder-decoder (whisper)
    takes a gradient pass as rank 0 of a (1, 2) mesh, its collectives
    logged, its gradients shaped as its slices; mamba and the hybrids
    build there (tests/test_torch_tp_ssm.py and
    tests/test_torch_tp_enc_dec.py run them)."""
    from repro_torch.launch.mesh import record_collectives
    from repro_torch.models import registry

    mesh = make_debug_mesh(1, 2).as_rank()
    w = get_smoke("whisper-base").replace(dtype="float32")
    params = registry.init_params(torch.Generator().manual_seed(0), w, "cpu", mesh=mesh)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, w.vocab_size, (2, 8)).astype(np.int32),
             "labels": rng.integers(0, w.vocab_size, (2, 8)).astype(np.int32),
             "encoder_frames": rng.normal(0, 1, (2, w.encoder_seq, w.d_model)).astype(
                 np.float32)}
    with record_collectives() as log:
        metrics, grads, _ = loop.make_grad_fn(w, device="cpu", mesh=mesh)(params, batch)
    assert np.isfinite(float(metrics["loss"])) and log.counts["all-reduce"] > 0
    assert all(g.shape == p.shape for g, p in zip(pytree.tree_leaves(grads),
                                                  pytree.tree_leaves(params)))
    assert callable(loop.make_eval_step(w, device="cpu", mesh=mesh))
    for arch in ("mamba2-130m", "jamba-v0.1-52b"):
        assert callable(loop.make_train_step(get_smoke(arch), optim.AdamWConfig(),
                                             device="cpu", mesh=mesh))
        assert callable(loop.make_eval_step(get_smoke(arch), device="cpu", mesh=mesh))
    # a data axis alone keeps every family
    loop.make_train_step(get_smoke("whisper-base"), optim.AdamWConfig(), device="cpu",
                         mesh=make_debug_mesh(2, 1).as_rank())


def test_global_norm_counts_replicated_leaves_once():
    """On a described rank the split leaves' sums are all-reduced (logged,
    one collective) and the replicated ones counted once; without a split
    the norm is the one-device sum, bit for bit."""
    from repro_torch.launch.mesh import record_collectives

    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(4, 3, generator=g), "b": torch.randn(5, generator=g)}
    one = optim.global_norm(tree)
    whole = [(0, ((4, False),)), (0, ((5, False),))]
    assert torch.equal(optim.global_norm(tree, (whole, None)), one)
    with record_collectives() as log:
        got = optim.global_norm(tree, ([(0, ((4, True),)), whole[1]], None))
    assert log.counts == {"all-reduce": 1} and log.bytes == {"all-reduce": 8}
    torch.testing.assert_close(got, one)


def test_wide_mm_backward_is_one_devices_bf16_product(monkeypatch):
    """The card's float32-output GEMM of a row-parallel partial
    (`layers._WideMM`; `torch.mm(..., out_dtype=)` has no derivative)
    differentiates as one device's bf16 product: here its forward runs
    through a stand-in for the card's `torch.mm`, and its gradients equal
    autograd's of ``x @ w`` in bf16, bit for bit."""
    from repro_torch.models import layers

    mm = torch.mm

    def wide(a, b, out_dtype=None):
        assert out_dtype == torch.float32
        return mm(a.float(), b.float())

    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 8, generator=g).bfloat16().requires_grad_(True)
    w = torch.randn(8, 5, generator=g).bfloat16().requires_grad_(True)
    gy = torch.randn(6, 5, generator=g).bfloat16()
    monkeypatch.setattr(torch, "mm", wide)
    y = layers._WideMM.apply(x, w)
    monkeypatch.setattr(torch, "mm", mm)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, x.float() @ w.float(), rtol=0, atol=0)
    got = torch.autograd.grad(y, [x, w], gy.float())
    x2, w2 = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    want = torch.autograd.grad(x2 @ w2, [x2, w2], gy)
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b) for a, b in zip(got, want))
