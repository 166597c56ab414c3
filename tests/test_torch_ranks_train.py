"""Data-parallel training over ranks (`repro_torch.launch.mesh`,
`training.loop.make_train_step(mesh=...)`, `models.moe.data_parallel`,
`launch.train` under `torch.distributed.run`) against the reference's
one-device step on the global batch.

Two gloo ranks on the CPU, launched with ``python -m
torch.distributed.run --standalone`` in a subprocess: each takes its half
of the same global batch, and its step must equal the reference's
`make_train_step` under `jax.jit` on the whole batch (the reference's
seeded params carried across with `params_from_jax`), for a dense, a moe
(at a capacity factor at which tokens drop), an ssm, an audio and the
convnet config, in float32. The MoE block alone is also run on each
rank's half of a token batch against the reference's `apply_moe` on all
of it: the global capacity, positions and drops decide which rows each
expert serves, so the outputs only agree when they agree.

Tolerances, as tests/test_torch_lm_train.py: the step's metrics (losses,
``grad_norm``, ``lr``) rtol / atol 2e-4; AdamW's first moment after the
step, which is 0.1 times the clipped gradient, rtol 2e-4 with atol 2e-4
* max|mu| of each leaf; the two ranks' updated params equal (each leaf's
float64 sum); dropped (token, slot) counts equal.
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
import torch.utils._pytree as pytree

from repro.configs import get_smoke as jget_smoke
from repro.models import convnet as jconv
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.training import checkpoint as jcheckpoint
from repro.training import loop as jloop
from repro.training import optim as joptim
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.models import convnet as tconv
from repro_torch.models import transformer as ttransformer

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = dict(rtol=2e-4, atol=2e-4)
OPT = dict(lr=2e-3, warmup_steps=2, total_steps=5)
B, S = 4, 16
FAMILIES = {
    "dense": ("qwen3-8b", {"num_layers": 4, "exit_layers": (0, 2),
                           "exit_loss_weights": (1.0, 0.5)}),
    # E = 4, top-2, C = int(64 * 2 * 0.5 / 4) + 1 = 17 of about 32 a expert
    "moe": ("granite-moe-3b-a800m", {"num_layers": 4, "moe_capacity_factor": 0.5}),
    "ssm": ("mamba2-130m", {"num_layers": 4, "ssm_chunk": 8}),
    "audio": ("whisper-base", {}),
}

WORKER = textwrap.dedent('''
    import pickle, sys
    import numpy as np, torch
    import torch.utils._pytree as pytree
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import join_ranks
    from repro_torch.models import convnet, moe, transformer
    from repro_torch.training import loop, optim

    mesh, backend = join_ranks("cpu")
    rank = mesh.coordinate("data")
    with open(sys.argv[1], "rb") as f:
        jobs = pickle.load(f)
    drops = []
    apply_moe = transformer.apply_moe

    def tapped(p, cfg, x):
        y, aux = apply_moe(p, cfg, x)
        drops.append(float(aux["moe_dropped_frac"]))
        return y, aux

    transformer.apply_moe = tapped
    out = {"backend": backend, "world": mesh.axis_size("data")}
    for name, job in jobs.items():
        cfg = job["cfg"]
        if name == "moe_layer":
            x = torch.from_numpy(job["x"])
            sh = shard_batch({"x": job["x"]}, mesh)
            p = {k: torch.from_numpy(v) for k, v in job["params"].items()}
            rows, einsum = [], moe.einsum

            def tap(spec, a, b):  # the expert buffer's rows (swiglu reads it twice)
                if spec == "ecd,edf->ecf" and not rows:
                    rows.append(a.shape[1])
                return einsum(spec, a, b)

            moe.einsum = tap
            with moe.data_parallel(mesh.group("data"), rank, mesh.axis_size("data")):
                y, aux = moe.apply_moe(p, cfg, torch.from_numpy(sh["x"]))
            moe.einsum = einsum
            out[name] = {"y": y.numpy(), "lo": sh.lo, "hi": sh.hi, "rows": rows,
                         "aux": {k: float(v) for k, v in aux.items()}}
            continue
        mod = convnet if cfg.family == "convnet" else transformer
        params = mod.params_from_jax(job["params"], device="cpu")
        step = loop.make_train_step(cfg, optim.AdamWConfig(**job["opt"]), mesh=mesh)
        drops.clear()
        new, state, m = step(params, optim.init(params), job["batch"])
        out[name] = {
            "metrics": {k: float(v) for k, v in m.items()},
            "mu": [a.numpy() for a in pytree.tree_leaves(state.mu)],
            "sums": [float(a.double().sum()) for a in pytree.tree_leaves(new)],
            "drops": list(drops),
            "sharded": shard_batch(job["batch"], mesh).sharded,
        }
    with open(f"{sys.argv[2]}.{rank}", "wb") as f:
        pickle.dump(out, f)
''')


def torchrun(args, nproc, timeout, cwd=None):
    """Start `nproc` gloo ranks on the CPU; returns the Popen."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc)] + args,
        env=env, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), timeout


def finish(run):
    proc, timeout = run
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"the ranks did not finish in {timeout} s:\n{err[-4000:]}")
    assert proc.returncode == 0, err[-4000:]
    return out


def _redraw_constants(tree, seed):
    """Constant leaves -> random, as tests/test_torch_lm_train.py draws
    them: ones -> U(0.5, 1.5), any other c -> c + N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def redraw(a):
        a = np.asarray(a)
        c = a.flat[0] if a.size else 0
        if a.size > 1 and np.all(a == c):
            v = rng.uniform(0.5, 1.5, a.shape) if c == 1 else c + rng.normal(0, 0.1, a.shape)
            return v.astype(np.float32).astype(a.dtype)
        return a

    return jax.tree.map(redraw, tree)


def _lm_batch(cfg, rows, seed):
    rng = np.random.default_rng(seed)
    win = rng.integers(0, cfg.vocab_size, (rows, S + 1)).astype(np.int32)
    out = {"tokens": win[:, :-1], "labels": win[:, 1:]}
    if cfg.is_encoder_decoder:
        out["encoder_frames"] = rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _jobs():
    """(jobs for the ranks, what the reference needs for each)."""
    jobs, ref = {}, {}
    for i, (family, (arch, kw)) in enumerate(FAMILIES.items()):
        jcfg = jget_smoke(arch).replace(dtype="float32", **kw)
        jparams = jax.tree.map(np.asarray, _redraw_constants(
            jregistry.init_params(jax.random.PRNGKey(0), jcfg), seed=1))
        batch = _lm_batch(jcfg, B, seed=10 + i)
        jobs[family] = dict(cfg=tget_smoke(arch).replace(dtype="float32", **kw),
                            params=jparams, batch=batch, opt=OPT)
        ref[family] = (jcfg, jparams, batch)
    # B % W != 0: every rank takes the whole batch of 3
    jcfg, jparams, _ = ref["dense"]
    batch = _lm_batch(jcfg, 3, seed=20)
    jobs["dense_b3"] = dict(jobs["dense"], batch=batch)
    ref["dense_b3"] = (jcfg, jparams, batch)
    # the convnet, the paper's B-AlexNet, at full width (it is CPU-sized)
    rng = np.random.default_rng(3)
    shapes = jax.eval_shape(jconv.init_params, jax.random.PRNGKey(0))
    cparams = jax.tree.map(lambda s: (rng.standard_normal(s.shape) / np.sqrt(
        np.prod(s.shape[:-1]) if len(s.shape) > 1 else 100.0)).astype(np.float32), shapes)
    cbatch = {"images": rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
              "labels": rng.integers(0, 10, 8).astype(np.int32)}
    jobs["convnet"] = dict(cfg=tconv.B_ALEXNET, params=cparams, batch=cbatch, opt=OPT)
    ref["convnet"] = (jconv.B_ALEXNET, cparams, cbatch)
    # the MoE block alone on (4, 16, d) tokens, drops included
    jcfg = ref["moe"][0]
    mp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(5), jcfg))
    x = np.random.default_rng(6).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jobs["moe_layer"] = dict(cfg=jobs["moe"]["cfg"], params=mp, x=x)
    ref["moe_layer"] = (jcfg, mp, x)
    return jobs, ref


_REFERENCE = {}


def _reference(name, ref):
    """The reference's one-device results for job `name` (computed once)."""
    if name not in _REFERENCE:
        _REFERENCE[name] = _compute_reference(name, *ref)
    return _REFERENCE[name]


def _compute_reference(name, cfg, params, batch):
    if name == "moe_layer":
        y, aux = jax.jit(lambda p, x: jmoe.apply_moe(p, cfg, x))(params, jnp.asarray(batch))
        return {"y": np.asarray(y), "aux": {k: float(v) for k, v in aux.items()}}
    step = jax.jit(jloop.make_train_step(cfg, joptim.AdamWConfig(**OPT)))
    jbatch = jax.tree.map(jnp.asarray, batch)
    _, state, m = step(params, joptim.init(params), jbatch)
    conv = tconv if cfg.family == "convnet" else ttransformer
    mu = pytree.tree_leaves(conv.params_from_jax(jax.tree.map(np.asarray, state.mu),
                                                 device="cpu"))
    out = {"metrics": {k: float(v) for k, v in m.items()}, "mu": [a.numpy() for a in mu]}
    if cfg.moe_num_experts:
        out["drops"] = _reference_drops(cfg, params, jbatch)
    return out


def _reference_drops(cfg, params, batch):
    """The dropped share of each MoE layer of the reference's forward, in
    layer order, read out of the jitted forward by a callback."""
    seen = []

    def tapped(p, c, x):
        y, aux = apply_moe(p, c, x)
        jax.debug.callback(lambda v: seen.append(float(v)), aux["moe_dropped_frac"],
                           ordered=True)
        return y, aux

    apply_moe = jmoe.apply_moe  # the reference's blocks import it at each call
    jmoe.apply_moe = tapped
    try:
        jax.block_until_ready(jax.jit(
            lambda p, b: jregistry.forward_train(p, cfg, b, remat=False))(params, batch))
        jax.effects_barrier()
    finally:
        jmoe.apply_moe = apply_moe
    return seen


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results for every job, the reference's inputs, and
    both ranks' results of a 2-rank `launch.train --smoke --ckpt`."""
    d = tmp_path_factory.mktemp("ranks_train")
    jobs, ref = _jobs()
    with open(d / "jobs.pkl", "wb") as f:
        pickle.dump(jobs, f)
    (d / "worker.py").write_text(WORKER)
    steps = torchrun([str(d / "worker.py"), str(d / "jobs.pkl"), str(d / "out")], 2, 300)
    ckpt = d / "ck.msgpack"
    train = torchrun(["-m", "repro_torch.launch.train", "--arch", "mamba2-130m", "--smoke",
                      "--steps", "2", "--batch", "4", "--seq", "16", "--device", "cpu",
                      "--log-every", "1", "--ckpt", str(ckpt)], 2, 300)
    for name in jobs:  # the reference's steps while the ranks run
        _reference(name, ref[name])
    finish(steps)
    log = finish(train)
    outs = []
    for r in range(2):
        with open(d / f"out.{r}", "rb") as f:
            outs.append(pickle.load(f))
    return outs, ref, log, ckpt


def _same_step(got, want):
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, err_msg=k, **TOL)
    assert len(got["mu"]) == len(want["mu"])
    for i, (g, w) in enumerate(zip(got["mu"], want["mu"])):
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"], atol=TOL["atol"] * np.abs(w).max(),
                                   err_msg=f"mu leaf {i}")


@pytest.mark.parametrize("family", list(FAMILIES) + ["convnet"])
def test_two_rank_step_matches_reference_one_device_step(ranks, family):
    outs, ref, _, _ = ranks
    want = _reference(family, ref[family])
    for out in outs:
        assert out["backend"] == "gloo" and out["world"] == 2
        assert out[family]["sharded"]
        _same_step(out[family], want)
    assert outs[0][family]["sums"] == outs[1][family]["sums"]
    if family == "moe":
        n = len(want["drops"])
        assert n == FAMILIES["moe"][1]["num_layers"]
        slots = B * S * ref["moe"][0].moe_top_k
        for out in outs:  # the forward's; the checkpointed recompute stops early
            drops = out["moe"]["drops"]
            assert [round(v * slots) for v in drops] == [round(v * slots)
                                                       for v in want["drops"]]
        assert min(want["drops"]) > 0


def test_moe_block_over_two_ranks_drops_what_one_device_drops(ranks):
    """Each rank's half of the tokens through the MoE block under
    `data_parallel`: the rows put together equal the reference's block on
    every token, the aux loss and the dropped share are the global ones."""
    outs, ref, _, _ = ranks
    want = _reference("moe_layer", ref["moe_layer"])
    got = np.concatenate([o["moe_layer"]["y"] for o in outs])
    assert [(o["moe_layer"]["lo"], o["moe_layer"]["hi"]) for o in outs] == [(0, 2), (2, 4)]
    np.testing.assert_allclose(got, want["y"], **TOL)
    slots = B * S * ref["moe_layer"][0].moe_top_k
    for o in outs:
        aux = o["moe_layer"]["aux"]
        np.testing.assert_allclose(aux["moe_aux_loss"], want["aux"]["moe_aux_loss"], **TOL)
        assert round(aux["moe_dropped_frac"] * slots) == round(
            want["aux"]["moe_dropped_frac"] * slots) > 0


def test_moe_rank_buffer_holds_only_its_kept_rows(ranks):
    """Under `data_parallel` a rank's expert buffer has as many rows as
    its fullest expert keeps (its slots, less what the lower ranks leave
    of the global capacity C), not C: counted here from the router in
    numpy, in the global token order."""
    from repro_torch.models.moe import moe_capacity

    outs, ref, _, _ = ranks
    cfg, mp, x = ref["moe_layer"]
    xt = x.reshape(-1, cfg.d_model)
    logits = xt @ mp["router"]
    top = np.argsort(-logits, axis=1)[:, :cfg.moe_top_k]  # softmax keeps the order
    C = moe_capacity(cfg, len(xt))
    counts = np.stack([np.bincount(top[r * len(xt) // 2:(r + 1) * len(xt) // 2].ravel(),
                                   minlength=cfg.moe_num_experts) for r in range(2)])
    below = np.concatenate([[0 * counts[0]], np.cumsum(counts, 0)[:-1]])
    want = [max(1, int(np.minimum(counts[r], np.clip(C - below[r], 0, None)).max()))
            for r in range(2)]
    assert [o["moe_layer"]["rows"] for o in outs] == [[w] for w in want]
    assert sum(want) < 2 * C, (want, C)


def test_batch_the_ranks_do_not_divide_runs_whole_on_each(ranks):
    """A global batch of 3 over 2 ranks: each rank takes all 3 rows (the
    reference's `fit_spec` drops the sharding) and steps as one device."""
    outs, ref, _, _ = ranks
    want = _reference("dense_b3", ref["dense_b3"])
    for out in outs:
        assert not out["dense_b3"]["sharded"]
        _same_step(out["dense_b3"], want)
    assert outs[0]["dense_b3"]["sums"] == outs[1]["dense_b3"]["sums"]


def test_two_rank_launch_train_writes_a_checkpoint_the_reference_reads(ranks):
    """`launch.train --smoke` over two ranks: rank 0 alone prints the log
    and writes --ckpt, in the reference's format."""
    _, _, log, ckpt = ranks
    lines = log.splitlines()
    assert sum(line.startswith("step ") for line in lines) == 2, log
    assert sum(line.startswith("mesh (data=2, model=1) over gloo") for line in lines) == 1
    cfg = jget_smoke("mamba2-130m")
    like = {"params": jregistry.init_params(jax.random.PRNGKey(0), cfg), "step": jnp.int32(0)}
    got = jcheckpoint.load(str(ckpt), like)
    assert int(got["step"]) == 2
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(like["params"])):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.isfinite(np.asarray(a, np.float32)).all()


class _Mesh:
    """A data mesh's two readings `data_rows` makes: size and coordinate."""

    def __init__(self, world, rank):
        self.world, self.rank = world, rank

    def axis_size(self, name):
        return self.world

    def coordinate(self, name):
        return self.rank


def test_rows_and_prefetch_take_the_ranks_shard():
    """Rows [r*B/W, (r+1)*B/W) of every global batch, as the reference's
    batch sharding; all of them where W does not divide B; prefetch moves
    only the shard."""
    import torch

    from repro_torch.data.pipeline import Shard, data_rows, prefetch, shard_batch

    assert [data_rows(8, _Mesh(4, r)) for r in range(4)] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert data_rows(6, _Mesh(4, 1)) == (0, 6) and data_rows(5, None) == (0, 5)
    batch = {"tokens": np.arange(12).reshape(6, 2), "labels": np.arange(6)}
    sh = shard_batch(batch, _Mesh(3, 2))
    assert isinstance(sh, Shard) and sh.sharded and (sh.lo, sh.hi, sh.rows) == (4, 6, 6)
    np.testing.assert_array_equal(sh["labels"], [4, 5])
    assert not shard_batch(batch, _Mesh(4, 2)).sharded
    got = list(prefetch(iter([batch, batch]), device="cpu", mesh=_Mesh(2, 1)))
    assert len(got) == 2 and all(isinstance(g, Shard) and g.lo == 3 for g in got)
    assert torch.equal(got[0]["tokens"], torch.as_tensor(batch["tokens"][3:]))


def test_rank_device_rules(monkeypatch):
    """A card per rank: cuda:LOCAL_RANK over NCCL; more ranks than cards:
    every rank on cuda:0 over gloo; the CPU only when named; no GPU and
    nothing named raises, and so does the rank launcher."""
    import torch

    from repro_torch._device import rank_device
    from repro_torch.launch.mesh import join_ranks

    assert rank_device("cpu", 1, 2) == (torch.device("cpu"), "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert rank_device(None, 3, 4) == (torch.device("cuda", 3), "nccl")
    assert rank_device("cuda", 1, 2) == (torch.device("cuda", 1), "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert rank_device(None, 1, 2) == (torch.device("cuda", 0), "gloo")
    with pytest.raises(ValueError, match="its card follows from LOCAL_RANK"):
        rank_device("cuda:1", 0, 2)
    with pytest.raises(ValueError, match="not one of 2 ranks"):
        rank_device(None, 2, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_device(None, 0, 2)
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0", LOCAL_WORLD_SIZE="2",
                     MASTER_ADDR="localhost", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        join_ranks()
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="lacks \\['MASTER_PORT'\\]"):
        join_ranks("cpu")
