"""Tensor parallelism of the encoder-decoder (whisper) on a model axis
(`sharding.layout_specs` under the reference's rules, `whisper.init_params(mesh=)`,
the cross-attention and the encoder's bidirectional attention on a rank's
heads, the vocab-parallel heads, the serve steps, the eval and train steps,
mesh checkpoints and the dry run's collectives) against the reference's
one-device functions.

Gloo ranks on the CPU, launched once per world size with ``python -m
torch.distributed.run --standalone`` in a subprocess: two ranks as a (data
1, model 2) mesh and four as (data 1, model 4). Every rank gets the same
global batches (tokens and encoder frames) and the reference's seeded
params (`params_from_jax` with constant leaves redrawn, so the LayerNorms'
scales and biases have teeth) and keeps its slices; the reference runs
the same params on one device under `jax.jit` while the ranks run. Two
float32 configs: the whisper smoke (4 heads, vocabulary 512: both split
over 2 and over 4 ranks), and a variant with 6 heads, 3 decoder layers,
two exits and an odd vocabulary of 513, whose heads 4 ranks do not divide
and whose vocabulary neither axis divides (the whole-leaf path: every
attention leaf and head whole on every rank, ``d_ff`` split).

Tolerances, as tests/test_torch_tp_ssm.py: logits and confidences rtol /
atol 2e-4; predictions equal where the reference's top-2 gap clears twice
that; gate decisions equal away from p_tar +- 1e-6; every gradient leaf
rtol 2e-4 with atol 2e-4 * max|g|; losses and params after 3 steps rtol /
atol 2e-4; the layout's cut, the replicated elements and the checkpoint
bit for bit.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro import sharding as jsharding
from repro.configs import get_smoke as jget_smoke
from repro.core.policy import OffloadPlan as JPlan
from repro.launch import serve as jserve
from repro.models import registry as jregistry
from repro.models import whisper as jwhisper
from repro.training import checkpoint as jcheckpoint
from repro.training import loop as jloop
from repro.training import optim as joptim
from repro_torch import sharding
from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke
from repro_torch.core.calibration import TemperatureScaling
from repro_torch.core.policy import OffloadPlan
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec, make_debug_mesh
from repro_torch.models import registry, whisper
from repro_torch.training import loop

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = dict(rtol=2e-4, atol=2e-4)
BOUNDARY = 1e-6
B, S, DECODE, STEPS = 4, 16, 4, 3
TEMPS = [1.3, 0.8]
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=5)
WORLDS = {2: (1, 2), 4: (1, 4)}  # ranks -> (data, model)
CONFIGS = {
    # the smoke as it is, in float32: 2 + 2 layers, 4 heads, vocab 512, exit (0,)
    "smoke": ("whisper-base", {}),
    # 6 heads (d 384), 3 decoder layers, exits after 0 and 1, vocab 513
    "odd": ("whisper-base", dict(d_model=384, num_heads=6, num_kv_heads=6, head_dim=64,
                                 vocab_size=513, num_layers=3, exit_layers=(0, 1),
                                 exit_loss_weights=(1.0, 0.5))),
}
CKPT = "smoke"

WORKER = textwrap.dedent('''
    import pickle, sys
    import numpy as np, torch
    import torch.utils._pytree as pytree
    from repro_torch import sharding
    from repro_torch.core.policy import OffloadPlan
    from repro_torch.launch.mesh import gather_whole, join_ranks, record_collectives
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.models import registry, whisper
    from repro_torch.training import checkpoint, loop, optim

    mesh, backend = join_ranks("cpu", model=int(sys.argv[3]))
    with open(sys.argv[1], "rb") as f:
        jobs = pickle.load(f)
    B, S, DECODE = jobs.pop("sizes")
    opt = jobs.pop("opt")
    out = {"backend": backend, "coords": (mesh.coordinate("data"), mesh.coordinate("model")),
           "shape": mesh.shape}

    def local(tree):  # copies: the train step updates the params in place
        return {sharding.path_str(p): a.detach().clone().numpy()
                for p, a in pytree.tree_flatten_with_path(tree)[0]}

    def floats(m):
        return {k: float(v) for k, v in m.items()}

    for name, job in jobs.items():
        cfg = job["cfg"]
        by_path = loop.whole_specs(cfg, mesh)

        def whole(tree):
            specs = sharding.lay_over(tree, by_path)
            return [a.numpy().copy() for a in pytree.tree_leaves(gather_whole(tree, specs, mesh))]

        params = whisper.params_from_jax(job["params"], "cpu", mesh=mesh)
        res = {"local": local(params), "gathered": whole(params),
               "init": local(registry.init_params(torch.Generator().manual_seed(0), cfg,
                                                  "cpu", mesh=mesh))}
        plan = OffloadPlan.from_json(job["plan"])
        batch = {"tokens": job["tokens"], "encoder_frames": job["frames"]}
        pre = make_prefill_step(cfg, plan=plan, mesh=mesh)(params, batch)
        res["prefill"] = {k: pre[k].numpy() for k in ("logits", "exit_confidence",
                                                      "exit_prediction")}
        # the serving path's cross caches, projected once from the frames
        with sharding.use_mesh(mesh), torch.no_grad():
            cross = whisper.prefill_cross_caches(params, cfg, torch.as_tensor(job["frames"]))
        res["cross_gap"] = max(float((a - b).abs().max()) for a, b in zip(
            pytree.tree_leaves(cross), pytree.tree_leaves(pre["caches"]["cross"])))
        caches = registry.init_cache(cfg, B, S + DECODE, device="cpu", mesh=mesh)
        res["cache"] = {sharding.path_str(p): tuple(a.shape)
                        for p, a in pytree.tree_flatten_with_path(caches)[0]}
        for dst, src in zip(pytree.tree_leaves(caches["self"]),
                            pytree.tree_leaves(pre["caches"]["self"])):
            dst.narrow(1, 0, S).copy_(src)
        caches["cross"] = cross
        step = make_serve_step(cfg, plan=plan, mesh=mesh)
        res["decode"] = []
        for t in range(DECODE):
            o, caches = step(params, job["decode"][:, t:t + 1], caches, S + t)
            res["decode"].append({k: v.numpy() for k, v in o.items()})
        ev = loop.make_eval_step(cfg, mesh=mesh)(params, job["batches"][0])
        res["eval"] = [z.numpy() for z in [ev["logits"]] + ev["exit_logits"]]
        with record_collectives() as log:
            metrics, grads, _ = loop.make_grad_fn(cfg, device="cpu", mesh=mesh)(
                params, job["batches"][0])
        res["metrics"], res["grads"] = floats(metrics), whole(grads)
        res["local_grads"], res["passes"] = local(grads), log.by_pass()
        if "ckpt" in job:  # the initial params' checkpoint
            path = f"{sys.argv[2]}.init.msgpack"
            specs = sharding.lay_over(params, by_path)
            checkpoint.save(path, params, mesh, specs)
            torch.distributed.barrier()
            back = checkpoint.load(path, params, mesh, specs)
            res["ckpt_back"] = all(torch.equal(a, b) for a, b in
                                   zip(pytree.tree_leaves(back), pytree.tree_leaves(params)))
            res["ckpt"] = path
        train = loop.make_train_step(cfg, optim.AdamWConfig(**opt), mesh=mesh, inplace=True)
        state = optim.init(params)
        res["steps"] = []
        for b in job["batches"]:
            params, state, m = train(params, state, b)
            res["steps"].append(floats(m))
        res["params"], res["local_after"] = whole(params), local(params)
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
    N(0, 0.1^2) (the LayerNorms' scales and biases get teeth)."""
    rng = np.random.default_rng(seed)

    def redraw(a):
        a = np.asarray(a)
        c = a.flat[0] if a.size else 0
        if a.size > 1 and np.all(a == c):
            v = rng.uniform(0.5, 1.5, a.shape) if c == 1 else c + rng.normal(0, 0.1, a.shape)
            return v.astype(np.float32).astype(a.dtype)
        return a

    return jax.tree.map(redraw, tree)


def _plan(p_tar, n_exits):
    return OffloadPlan(p_tar=p_tar, calibrators=[TemperatureScaling.from_temperature(t)
                                                 for t in TEMPS[:n_exits]])


def _cfgs(name):
    arch, kw = CONFIGS[name]
    return (jget_smoke(arch).replace(dtype="float32", **kw),
            get_smoke(arch).replace(dtype="float32", **kw))


def _jobs():
    jobs, ref = {"sizes": (B, S, DECODE), "opt": OPT}, {}
    rng = np.random.default_rng(11)
    for i, name in enumerate(CONFIGS):
        jcfg, cfg = _cfgs(name)
        jparams = jax.tree.map(np.asarray, _redraw_constants(
            jregistry.init_params(jax.random.PRNGKey(i), jcfg), seed=i))
        V, E, d = jcfg.vocab_size, jcfg.encoder_seq, jcfg.d_model
        frames = rng.normal(0, 1, (B, E, d)).astype(np.float32)
        toks = rng.integers(0, V, (B, S)).astype(np.int32)
        dec = rng.integers(0, V, (B, DECODE)).astype(np.int32)
        batches = []
        for _ in range(STEPS):
            win = rng.integers(0, V, (B, S + 1)).astype(np.int32)
            batches.append({"tokens": win[:, :-1], "labels": win[:, 1:],
                            "encoder_frames": rng.normal(0, 1, (B, E, d)).astype(np.float32)})
        # p_tar between the two middle calibrated exit-0 confidences of the
        # reference's prefill, so both decisions occur
        z = jax.jit(lambda p, b: jwhisper.forward_prefill(p, jcfg, b))(
            jparams, {"tokens": jnp.asarray(toks), "encoder_frames": jnp.asarray(frames)}
        )["exit_logits"][0][:, 0]
        conf = np.sort(np.asarray(jax.nn.softmax(np.asarray(z) / TEMPS[0], axis=-1).max(-1)))
        p_tar = float(conf[B // 2 - 1] + conf[B // 2]) / 2
        assert np.abs(conf - p_tar).min() > BOUNDARY
        plan = _plan(p_tar, len(cfg.exit_layers))
        jobs[name] = dict(cfg=cfg, params=jparams, tokens=toks, frames=frames, decode=dec,
                          batches=batches, plan=plan.to_json())
        if name == CKPT:
            jobs[name]["ckpt"] = True
        ref[name] = (jcfg, jparams, toks, frames, dec, batches, plan)
    return jobs, ref


_REF = {}


def _reference(name, ref):
    if name not in _REF:
        _REF[name] = _compute_reference(*ref[name])
    return _REF[name]


def _port_leaves(tree):
    """A reference tree's leaves in the port's order (the order
    `params_from_jax` gives the ranks' trees)."""
    return pytree.tree_leaves(whisper.params_from_jax(tree, "cpu"))


def _compute_reference(cfg, params, toks, frames, dec, batches, plan):
    jplan = JPlan.from_json(plan.to_json())
    batch = {"tokens": jnp.asarray(toks), "encoder_frames": jnp.asarray(frames)}
    pre = jax.jit(jserve.make_prefill_step(cfg, plan=jplan))(params, batch)
    fwd = jax.jit(lambda p, b: jwhisper.forward_prefill(p, cfg, b))(params, batch)
    out = {"prefill": {k: np.asarray(pre[k]) for k in ("logits", "exit_confidence",
                                                       "exit_prediction")},
           "prefill_exit_logits": [np.asarray(z[:, 0]) for z in fwd["exit_logits"]]}
    # decode on from the prefill's self caches, grown to S + DECODE slots,
    # and the cross caches projected once from the frames
    caches = jregistry.init_cache(cfg, B, S + DECODE)
    caches = {"self": [{k: c[k].at[:, :S].set(p[k]) for k in ("k", "v")}
                       for c, p in zip(caches["self"], pre["caches"]["self"])],
              "cross": jax.jit(lambda p, f: jwhisper.prefill_cross_caches(p, cfg, f))(
                  params, batch["encoder_frames"])}
    step = jax.jit(jserve.make_serve_step(cfg, plan=jplan))
    dstep = jax.jit(lambda p, t, c, pos: jwhisper.decode_step(p, cfg, t, c, pos))
    out["decode"], out["decode_exit_logits"] = [], []
    for t in range(DECODE):
        tok, pos = jnp.asarray(dec[:, t:t + 1]), jnp.int32(S + t)
        o, new = step(params, tok, caches, pos)
        d, _ = dstep(params, tok, caches, pos)
        caches = new
        out["decode"].append({k: np.asarray(v) for k, v in o.items()})
        out["decode_exit_logits"].append([np.asarray(z[:, 0]) for z in d["exit_logits"]])
    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    ev = jax.jit(lambda p, b: jwhisper.forward_train(p, cfg, b, remat=False))(params, jb[0])
    out["eval"] = [np.asarray(z) for z in [ev["logits"]] + ev["exit_logits"]]
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jloop.loss_fn(p, cfg, b, True), has_aux=True))(params, jb[0])
    train = jax.jit(jloop.make_train_step(cfg, joptim.AdamWConfig(**OPT)))
    p, state, steps = params, joptim.init(params), []
    for b in jb:
        p, state, m = train(p, state, b)
        steps.append({k: float(v) for k, v in m.items()})
    out.update(metrics={k: float(v) for k, v in metrics.items()},
               grads=[np.asarray(g) for g in _port_leaves(grads)], steps=steps,
               params=[np.asarray(a) for a in _port_leaves(p)])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results for every job at each world size, and the
    reference's inputs."""
    d = tmp_path_factory.mktemp("tp_enc_dec")
    jobs, ref = _jobs()
    with open(d / "jobs.pkl", "wb") as f:
        pickle.dump(jobs, f)
    (d / "worker.py").write_text(WORKER)
    runs = {w: torchrun([str(d / "worker.py"), str(d / "jobs.pkl"), str(d / f"out{w}"),
                         str(WORLDS[w][1])], w, 400) for w in WORLDS}
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


def _rank_mesh(world, coords):
    return MeshSpec(("data", "model"), WORLDS[world]).as_rank(coords)


def _decided(got_pred, want_pred, want_logits, temp):
    """Predictions equal wherever the reference's top-2 gap of z/T clears
    twice the logits' tolerance; returns how many rows that is."""
    z = np.asarray(want_logits, np.float32) / temp
    top2 = np.sort(z, axis=-1)[..., -2:]
    tol = 2 * (TOL["atol"] + TOL["rtol"] * np.abs(top2[..., 1])) / temp
    clear = (top2[..., 1] - top2[..., 0]) > tol
    np.testing.assert_array_equal(np.asarray(got_pred)[clear], np.asarray(want_pred)[clear])
    return int(clear.sum())


def _decisions(got_conf, want_conf, p_tar):
    """Gate decisions equal away from p_tar +- 1e-6 (hazard d); returns how
    many that is."""
    clear = np.abs(want_conf - p_tar) > BOUNDARY
    np.testing.assert_array_equal((got_conf >= p_tar)[clear], (want_conf >= p_tar)[clear])
    return int(clear.sum())


def _split(name, world):
    """(heads split, vocab split) of config `name` over `world` model ranks."""
    cfg = _cfgs(name)[1]
    return cfg.num_heads % world == 0, cfg.vocab_size % world == 0


# ------------------------------------------------------------------- tests
def test_mesh_layout(ranks):
    outs, _ = ranks
    for w, (data, model) in WORLDS.items():
        got = sorted(o["coords"] for o in outs[w])
        assert got == [(i, j) for i in range(data) for j in range(model)], got
        assert all(o["backend"] == "gloo" and o["shape"] == (data, model) for o in outs[w])


def _jspecs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jsharding._path_str(p): tuple(s) for p, s in leaves}


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_layout_is_the_reference_specs(world, name):
    """The port's layout of whisper's params (`layout_specs`, what a rank's
    slices are cut by) and of its self and cross caches (`cache_layout`)
    is the reference's `param_specs` / `cache_specs_tree` over the same
    (data 1, model W) mesh: heads and ``d_ff`` split where W divides
    them, the embedding and heads vocab-parallel where W divides the
    vocabulary, ``pos_embed`` / ``enc_pos_embed`` and the norms whole."""
    jcfg, cfg = _cfgs(name)
    mesh = make_debug_mesh(*WORLDS[world])
    try:
        jsharding.set_mesh(SimpleNamespace(axis_names=("data", "model"),
                                           devices=np.empty(WORLDS[world])))
        want = _jspecs(jsharding.param_specs(jregistry.param_specs_shapes(jcfg)))
        jcache = jregistry.init_cache(jcfg, B, S)
        want_cache = _jspecs(jsharding.cache_specs_tree(jcache))
    finally:
        jsharding.set_mesh(None)
    got = sharding.specs_by_path(registry.param_specs_shapes(cfg), mesh)
    assert got == want
    heads, vocab = _split(name, world)
    assert (got["dec_blocks/0/cross_attn/wk"] == (None, "model", None)) == heads
    assert (got["exits/0/head/w"] == (None, "model")) == vocab
    assert got["pos_embed"] == got["enc_pos_embed"] == (None, None)
    assert got["enc_blocks/0/ffn_norm/bias"] == got["final_norm/scale"] == ()
    assert got["enc_blocks/0/mlp/w_up"] == (None, "model")
    whole_cache = whisper.init_cache(cfg, B, S, device="meta")
    got_cache = {sharding.path_str(p): s for p, s in pytree.tree_flatten_with_path(
        sharding.cache_layout(whole_cache, mesh), is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert got_cache == want_cache
    # the batch rows on the data axis (of one rank here), the kv heads on the model axis
    assert got_cache["cross/0/k"] == ("data", None, "model" if heads else None, None)


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_layout_cut_is_the_one_device_slice(ranks, world, name):
    """init_params(mesh=) and params_from_jax(mesh=) give each rank, bit for
    bit, its cut of the one-device params under the layout (the rank's
    heads of every attention, its block of ``d_ff`` and of the vocabulary,
    the rest whole), `gather_whole` gives the whole tree back, and the
    caches a rank allocates hold its kv heads."""
    outs, ref = ranks
    cfg = _cfgs(name)[1]
    full = whisper.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    jfull = whisper.params_from_jax(ref[name][1], "cpu")
    model = WORLDS[world][1]
    heads, vocab = _split(name, world)
    for out in outs[world]:
        mesh = _rank_mesh(world, out["coords"])
        got = out[name]
        for what, tree in (("init", full), ("local", jfull)):
            flat = pytree.tree_flatten_with_path(tree)[0]
            want = sharding.local_shards(tree, sharding.layout_specs(tree, mesh), mesh)
            for (p, _), w_ in zip(flat, pytree.tree_leaves(want)):
                np.testing.assert_array_equal(got[what][sharding.path_str(p)], w_.numpy())
        for g, w_ in zip(got["gathered"], pytree.tree_leaves(jfull)):
            np.testing.assert_array_equal(g, w_.numpy())
        m = out["coords"][1]
        hl = cfg.num_heads // model if heads else cfg.num_heads
        wq = full["dec_blocks"][1]["cross_attn"]["wq"].numpy()
        np.testing.assert_array_equal(got["init"]["dec_blocks/1/cross_attn/wq"],
                                      wq[:, m * hl:(m + 1) * hl] if heads else wq)
        emb, vl = full["embed"]["w"].numpy(), cfg.vocab_size // model
        np.testing.assert_array_equal(got["init"]["embed/w"],
                                      emb[m * vl:(m + 1) * vl] if vocab else emb)
        np.testing.assert_array_equal(got["init"]["pos_embed"], full["pos_embed"].numpy())
        for path, shape in got["cache"].items():
            assert shape[-2] == hl, (path, shape)
            assert shape[1] == (cfg.encoder_seq if path.startswith("cross") else S + DECODE)


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_serve_steps_match_reference(ranks, world, name):
    """The prefill step's logits, exit confidences, predictions and gate
    decisions, then four decode steps from its self caches and the cross
    caches `prefill_cross_caches` projects (each rank's vocab shard of the
    logits, the global argmax, the exits' gates), against the reference's
    jitted steps on one device; the projected cross caches equal the
    prefill's."""
    outs, ref = ranks
    want = _reference(name, ref)
    p_tar = ref[name][6].p_tar
    n_ex = len(_cfgs(name)[1].exit_layers)
    decided = 0
    for out in outs[world]:
        got = out[name]
        assert got["cross_gap"] <= 1e-6
        pre = got["prefill"]
        np.testing.assert_allclose(pre["logits"], want["prefill"]["logits"], **TOL)
        np.testing.assert_allclose(pre["exit_confidence"], want["prefill"]["exit_confidence"],
                                   **TOL)
        for i in range(n_ex):
            decided += _decided(pre["exit_prediction"][i], want["prefill"]["exit_prediction"][i],
                                want["prefill_exit_logits"][i], TEMPS[i])
            decided += _decisions(pre["exit_confidence"][i],
                                  want["prefill"]["exit_confidence"][i], p_tar)
        for t in range(DECODE):
            w, o = want["decode"][t], got["decode"][t]
            n_v = o["logits"].shape[-1]
            lo = 0 if n_v == w["logits"].shape[-1] else out["coords"][1] * n_v
            np.testing.assert_allclose(o["logits"], w["logits"][:, lo:lo + n_v], **TOL)
            np.testing.assert_allclose(o["exit_confidence"], w["exit_confidence"], **TOL)
            for i in range(n_ex):
                decided += _decided(o["exit_prediction"][i], w["exit_prediction"][i],
                                    want["decode_exit_logits"][t][i], TEMPS[i])
                decided += _decisions(o["exit_confidence"][i], w["exit_confidence"][i], p_tar)
            decided += _decided(o["token"], w["token"], w["logits"], 1.0)
    assert decided >= len(outs[world]) * B * (1 + DECODE) * (2 * n_ex + 1) // 2


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_eval_step_matches_reference(ranks, world, name):
    """make_eval_step over the mesh returns one device's whole-vocab final
    and exit logits of the batch on every rank."""
    outs, ref = ranks
    want = _reference(name, ref)["eval"]
    for out in outs[world]:
        for g, w in zip(out[name]["eval"], want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, **TOL)


def _close_leaves(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"], atol=TOL["atol"] * np.abs(w).max(),
                                   err_msg=f"{what} leaf {i}")


def _same_whole_leaves(outs, world, name, key):
    """Every leaf the model ranks hold whole is the same bit for bit on every
    rank; returns how many elements that is."""
    cfg = _cfgs(name)[1]
    by_path = loop.whole_specs(cfg, make_debug_mesh(*WORLDS[world]))
    first = outs[0][name][key]
    n = 0
    for path, spec in by_path.items():
        if "model" in spec:
            continue
        n += first[path].size
        for out in outs[1:]:
            np.testing.assert_array_equal(out[name][key][path], first[path],
                                          err_msg=f"{name} {key} {path}")
    assert n > 0
    return n


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_gradients_match_reference(ranks, world, name):
    """The loss, its metrics and every gradient leaf (a rank's blocks
    gathered whole) on every rank against the reference's
    ``jax.value_and_grad(loss_fn)`` on one device; the replicated leaves'
    gradients (the norms, the position embeddings, every whole attention
    leaf and head) bit-equal over the model ranks."""
    outs, ref = ranks
    want = _reference(name, ref)
    for out in outs[world]:
        got = out[name]
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, err_msg=k, **TOL)
        _close_leaves(got["grads"], want["grads"], f"{name} grads")
    _same_whole_leaves(outs[world], world, name, "local_grads")


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_steps_match_reference(ranks, world, name):
    """Three AdamW steps (remat, the in-place update, the global norm over
    the split leaves): every step's losses, ``grad_norm`` and learning
    rate, and the parameters after them, gathered whole, against the
    reference's jitted `train_step`; the replicated leaves the same on
    every rank after them."""
    outs, ref = ranks
    want = _reference(name, ref)
    for out in outs[world]:
        got = out[name]
        for t, (g, w) in enumerate(zip(got["steps"], want["steps"])):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], err_msg=f"step {t} {k}", **TOL)
        for i, (g, w) in enumerate(zip(got["params"], want["params"])):
            np.testing.assert_allclose(g, w, err_msg=f"{name} param {i}", **TOL)
    _same_whole_leaves(outs[world], world, name, "local_after")


@pytest.mark.parametrize("world", list(WORLDS))
def test_mesh_checkpoint_is_the_reference_file(ranks, world):
    """The ranks' checkpoint of their slices, written by rank 0, loads in the
    reference's `checkpoint.load` as the one-device params bit for bit, and
    each rank's mesh load gives back its own slices."""
    outs, ref = ranks
    jparams = ref[CKPT][1]
    got = outs[world][0][CKPT]
    loaded = jcheckpoint.load(got["ckpt"], jparams)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert all(out[CKPT]["ckpt_back"] for out in outs[world])


def _grad_pass_counts(cfg, world):
    """The all-reduces of one tensor-parallel gradient pass of `cfg` over a
    model axis of `world` (remat), worked out from its layers. Forward:
    the vocab-parallel embedding's, the row-parallel reduces (attention
    out and MLP down: two an encoder layer; self-attention, cross-attention
    and MLP: three a decoder layer), two a head for the vocab-parallel
    loss. Backward: each split product's input entering the split (an
    encoder layer's attention input once for q, k and v, and its MLP's; a
    decoder layer's self-attention, cross-attention queries and MLP), the
    encoder output once for every cross-attention's k and v, each head's
    input. Recompute: the decoder blocks' attention reduces, whose outputs
    feed what the backward saved; the MLP's feeds nothing saved. A whole
    leaf adds none (heads or vocabulary the axis does not divide)."""
    heads = cfg.num_heads % world == 0
    vocab = cfg.vocab_size % world == 0
    Le, Ld, n_heads = cfg.encoder_layers, cfg.num_layers, 1 + len(cfg.exit_layers)
    a = 1 if heads else 0
    forward = int(vocab) + Le * (1 + a) + Ld * (1 + 2 * a) + 2 * n_heads * int(vocab)
    backward = Le * (1 + a) + Ld * (1 + 2 * a) + a + n_heads * int(vocab)
    return forward, backward, 2 * Ld * a


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_collectives_of_a_step_by_pass(ranks, world, name):
    """The gradient pass's all-reduces by pass, as `_grad_pass_counts` works
    them out; the backward's bytes are the float32 gradients of the
    entered activations."""
    outs, _ = ranks
    cfg = _cfgs(name)[1]
    forward, backward, recompute = _grad_pass_counts(cfg, world)
    heads, vocab = _split(name, world)
    E, d = cfg.encoder_seq, cfg.d_model
    n_heads = 1 + len(cfg.exit_layers)
    for out in outs[world]:
        passes = out[name]["passes"]
        assert passes["forward"]["counts"] == {"all-reduce": forward}
        assert passes["backward"]["counts"] == {"all-reduce": backward}
        assert passes.get("recompute", {}).get("counts", {}).get("all-reduce", 0) == recompute
        enc_in = cfg.encoder_layers * (1 + heads) + heads  # the encoder output once
        dec_in = cfg.num_layers * (1 + 2 * heads) + n_heads * vocab
        assert passes["backward"]["bytes"] == {"all-reduce": 4 * d * B * (E * enc_in
                                                                          + S * dec_in)}


@pytest.mark.parametrize("arch,shape,smoke", [("whisper-base", "train_4k", True),
                                              ("whisper-base", "decode_32k", False)])
def test_dryrun_pairs_as_rank_0(arch, shape, smoke):
    """whisper-base's pairs on a (data 1, model 2) mesh are traced as rank 0
    with their collective schedule: the smoke's train step (vocabulary 512
    split) by pass, as `_grad_pass_counts` works it out, plus the global
    norm's all-reduce; the uncut decode step (vocabulary 51 865 whole: no
    embedding all-reduce, no vocab gather) its three row-parallel reduces
    a decoder layer, each a (b, 1, d) float32 partial."""
    r = dryrun.run_one(arch, shape, None, mesh="1x2", device="cpu", smoke=smoke)
    assert r["traced_as"] == "rank 0" and r["ok"]
    assert r["memory"]["params_bytes"] == r["per_card_bytes"]["params"]
    cfg = (get_smoke if smoke else get_config)(arch)
    sh = INPUT_SHAPES[shape]
    if sh.kind == "train":
        forward, backward, recompute = _grad_pass_counts(cfg, 2)
        passes = r["collective_passes"]
        assert passes["forward"]["counts"] == {"all-reduce": forward + 1}
        assert passes["backward"]["counts"] == {"all-reduce": backward}
        assert passes["recompute"]["counts"] == {"all-reduce": recompute}
        assert r["collective_counts"] == {"all-reduce": forward + 1 + backward + recompute}
    else:
        assert cfg.vocab_size % 2 == 1
        assert r["collective_counts"] == {"all-reduce": 3 * cfg.num_layers}
        assert r["collective_bytes"] == {"all-reduce": 3 * cfg.num_layers * sh.global_batch
                                         * cfg.d_model * 4}
