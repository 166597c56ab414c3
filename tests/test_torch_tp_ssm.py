"""Tensor parallelism of the mamba and hybrid families on a model axis
(`sharding.layout_specs` / `cache_layout` with mamba's packed leaves,
`models.mamba` on its block of SSD heads, the serve steps, `lm_engine`,
the train step, `optim.global_norm` over a packed leaf, mesh checkpoints
and the dry run's collectives) against the reference's one-device
functions.

Gloo ranks on the CPU, launched once per world size with ``python -m
torch.distributed.run --standalone`` in a subprocess: two ranks as a
(data 1, model 2) mesh and four as (data 1, model 4). Every rank gets the
same global batches and the reference's seeded params (`params_from_jax`
with constant leaves redrawn, so norm scales, D and the conv bias have
teeth, and dt_bias stays near its init: ROADMAP §3 (k)) and keeps its
slices; the reference runs the same params on one device under `jax.jit`
while the ranks run. Four float32 smoke configs: mamba2-130m at 4 layers
(a stacked segment, two exits; 16 SSD heads), jamba-v0.1-52b at 4
layers (attention, mamba and MoE blocks, 4 experts, capacity factor 0.5
so tokens drop), mamba2-130m in the split-proj variant (``dt_proj``
whole), and mamba2-130m at d_model 240, whose 15 SSD heads neither
model axis divides (every mamba leaf whole on every rank).

Tolerances, as tests/test_torch_tp.py and tests/test_torch_tp_train.py:
logits and confidences rtol / atol 2e-4; predictions equal where the
reference's top-2 gap clears twice that; gate decisions equal away from
p_tar +- 1e-6; every gradient leaf rtol 2e-4 with atol 2e-4 * max|g|;
losses and params after 3 steps rtol / atol 2e-4; dropped counts and
payload_bytes equal; the layout's cut, the replicated elements (the B
and C columns of the packed leaves among them) and the checkpoint bit
for bit.
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
from repro.core.policy import OffloadPlan as JPlan
from repro.launch import serve as jserve
from repro.models import registry as jregistry
from repro.models import transformer as jtr
from repro.offload.engine import lm_engine as jlm_engine
from repro.training import checkpoint as jcheckpoint
from repro.training import loop as jloop
from repro.training import optim as joptim
from repro_torch import sharding
from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke
from repro_torch.core.calibration import TemperatureScaling
from repro_torch.core.policy import OffloadPlan
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec, make_debug_mesh, record_collectives
from repro_torch.models import registry, transformer
from repro_torch.training import loop, optim

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = dict(rtol=2e-4, atol=2e-4)
BOUNDARY = 1e-6
B, S, DECODE, STEPS = 4, 32, 4, 3  # S: two of the smokes' 16-token chunks
TEMPS = [1.3, 0.8]
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=5)
WORLDS = {2: (1, 2), 4: (1, 4)}  # ranks -> (data, model)
CONFIGS = {
    # exits after layers 0 and 2 of 4: a one-layer segment, a stacked one
    "mamba": ("mamba2-130m", dict(num_layers=4, exit_layers=(0, 2),
                                  exit_loss_weights=(1.0, 0.5))),
    # attention at layers 0 and 2, mamba + MoE at 1 and 3; E = 4, top-2,
    # C = int(128 * 2 * 0.5 / 4) + 1 = 33 of 64 slots an expert: tokens drop
    "jamba": ("jamba-v0.1-52b", dict(num_layers=4, exit_layers=(0, 2),
                                     exit_loss_weights=(1.0, 0.5), moe_capacity_factor=0.5)),
    # dt kept out of in_proj: dt_proj (d, heads) whole on every rank
    "split_proj": ("mamba2-130m", dict(mamba_split_proj=True)),
    # d_inner 480: 15 SSD heads, which neither 2 nor 4 divides
    "whole": ("mamba2-130m", dict(d_model=240)),
}
ENGINE = "jamba"

WORKER = textwrap.dedent('''
    import pickle, sys
    import numpy as np, torch
    import torch.utils._pytree as pytree
    from repro_torch import sharding
    from repro_torch.core.policy import OffloadPlan
    from repro_torch.launch.mesh import gather_whole, join_ranks, record_collectives
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.models import registry, transformer
    from repro_torch.offload.engine import lm_engine
    from repro_torch.training import checkpoint, loop, optim

    mesh, backend = join_ranks("cpu", model=int(sys.argv[3]))
    with open(sys.argv[1], "rb") as f:
        jobs = pickle.load(f)
    B, S, DECODE = jobs.pop("sizes")
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

        params = transformer.params_from_jax(job["params"], "cpu", mesh=mesh)
        res = {"local": local(params), "gathered": whole(params),
               "init": local(registry.init_params(torch.Generator().manual_seed(0), cfg,
                                                  "cpu", mesh=mesh))}
        plan = OffloadPlan.from_json(job["plan"])
        drops.clear()
        pre = make_prefill_step(cfg, plan=plan, mesh=mesh)(params, {"tokens": job["tokens"]})
        res["prefill"] = {k: pre[k].numpy() for k in ("logits", "exit_confidence",
                                                      "exit_prediction")}
        res["drops"] = list(drops)
        step = make_serve_step(cfg, plan=plan, mesh=mesh)
        caches = registry.init_cache(cfg, B, DECODE, device="cpu", mesh=mesh)
        res["cache"] = {sharding.path_str(p): tuple(a.shape)
                        for p, a in pytree.tree_flatten_with_path(caches)[0]}
        res["decode"] = []
        for t in range(DECODE):
            o, caches = step(params, job["tokens"][:, t:t + 1], caches, t)
            res["decode"].append({k: v.numpy() for k, v in o.items()})
        # decode on from the prefill's own caches, grown to S + DECODE slots
        grown = registry.init_cache(cfg, B, S + DECODE, device="cpu", mesh=mesh)
        for dst, src in zip(pytree.tree_leaves(grown), pytree.tree_leaves(pre["caches"])):
            dst.narrow(-3, 0, src.shape[-3]).copy_(src)
        res["resume"] = []
        tok = job["next"]
        for t in range(DECODE):
            o, grown = step(params, tok, grown, S + t)
            res["resume"].append({k: v.numpy() for k, v in o.items()})
            tok = o["token"][:, None]
        if "engine" in job:
            res["engine"] = {}
            for level, jplan in job["engine"].items():
                eng = lm_engine(params, cfg, OffloadPlan.from_json(jplan), mesh=mesh)
                r = eng.infer({"tokens": job["tokens"]})
                res["engine"][level] = dict(r, payload_bytes=eng.stats.payload_bytes,
                                            offloaded=eng.stats.offloaded)
        drops.clear()
        with record_collectives() as log:
            metrics, grads, _ = loop.make_grad_fn(cfg, device="cpu", mesh=mesh)(
                params, job["batches"][0])
        res["metrics"], res["grads"] = floats(metrics), whole(grads)
        res["local_grads"], res["passes"] = local(grads), log.by_pass()
        res["train_drops"] = list(drops)
        if name == "mamba":  # the initial params' checkpoint
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
    N(0, 0.1^2) (zero biases get teeth, dt_bias stays near its init)."""
    rng = np.random.default_rng(seed)

    def redraw(a):
        a = np.asarray(a)
        c = a.flat[0] if a.size else 0
        if a.size > 1 and np.all(a == c):
            v = rng.uniform(0.5, 1.5, a.shape) if c == 1 else c + rng.normal(0, 0.1, a.shape)
            return v.astype(np.float32).astype(a.dtype)
        return a

    return jax.tree.map(redraw, tree)


def _plan(p_tar=0.5, n_exits=2):
    return OffloadPlan(p_tar=p_tar, calibrators=[TemperatureScaling.from_temperature(t)
                                                 for t in TEMPS[:n_exits]])


def _cfgs(name):
    arch, kw = CONFIGS[name]
    return (jget_smoke(arch).replace(dtype="float32", **kw),
            get_smoke(arch).replace(dtype="float32", **kw))


def _jobs():
    jobs, ref = {"sizes": (B, S, DECODE), "opt": OPT}, {}
    rng = np.random.default_rng(7)
    for i, name in enumerate(CONFIGS):
        jcfg, cfg = _cfgs(name)
        jparams = jax.tree.map(np.asarray, _redraw_constants(
            jregistry.init_params(jax.random.PRNGKey(i), jcfg), seed=i))
        toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        nxt = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        batches = []
        for _ in range(STEPS):
            win = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
            batches.append({"tokens": win[:, :-1], "labels": win[:, 1:]})
        n_ex = len(cfg.exit_layers)
        jobs[name] = dict(cfg=cfg, params=jparams, tokens=toks, next=nxt, batches=batches,
                          plan=_plan(n_exits=n_ex).to_json())
        ref[name] = (jcfg, jparams, toks, nxt, batches)
    # lm_engine: exit 0 at T 1.3, p_tar between the two middle calibrated
    # confidences of the reference's edge, so both outcomes occur
    jcfg, jparams, toks = ref[ENGINE][:3]
    z = jtr.edge_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})["exit_logits"][:, 0]
    conf = np.sort(np.asarray(jax.nn.softmax(np.asarray(z) / TEMPS[0], axis=-1).max(-1)))
    assert np.abs(conf - (conf[B // 2 - 1] + conf[B // 2]) / 2).min() > BOUNDARY
    p_tar = float(conf[B // 2 - 1] + conf[B // 2]) / 2
    jobs[ENGINE]["engine"] = {lv: _plan(p_tar).with_compression(lv).to_json()
                              for lv in (0, 1, 2)}
    return jobs, ref


_REF = {}


def _reference(name, ref):
    if name not in _REF:
        _REF[name] = _compute_reference(*ref[name])
    return _REF[name]


def _port_leaves(tree):
    """A reference tree's leaves in the port's order (the order
    `params_from_jax` gives the ranks' trees)."""
    return pytree.tree_leaves(transformer.params_from_jax(tree, "cpu"))


def _compute_reference(cfg, params, toks, nxt, batches):
    n_ex = len(cfg.exit_layers)
    jplan = JPlan.from_json(_plan(n_exits=n_ex).to_json())
    pre = jax.jit(jserve.make_prefill_step(cfg, plan=jplan))(params,
                                                             {"tokens": jnp.asarray(toks)})
    fwd = jtr.forward_prefill(params, cfg, {"tokens": jnp.asarray(toks)})
    out = {"prefill": {k: np.asarray(pre[k]) for k in ("logits", "exit_confidence",
                                                       "exit_prediction")},
           "prefill_exit_logits": [np.asarray(z[:, 0]) for z in fwd["exit_logits"]]}
    step = jax.jit(jserve.make_serve_step(cfg, plan=jplan))
    dec = jax.jit(lambda p, t, c, pos: jtr.decode_step(p, cfg, t, c, pos))
    caches = jregistry.init_cache(cfg, B, DECODE)
    out["decode"], out["decode_exit_logits"] = [], []
    for t in range(DECODE):
        tok = jnp.asarray(toks[:, t:t + 1])
        o, new = step(params, tok, caches, jnp.int32(t))
        d, _ = dec(params, tok, caches, jnp.int32(t))
        caches = new
        out["decode"].append({k: np.asarray(v) for k, v in o.items()})
        out["decode_exit_logits"].append([np.asarray(z[:, 0]) for z in d["exit_logits"]])
    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
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


def _port_resume(name, ref):
    """The port's one-device prefill and decode from its caches."""
    _, jparams, toks, nxt, _ = ref[name]
    cfg = _cfgs(name)[1]
    plan = _plan(n_exits=len(cfg.exit_layers))
    params = transformer.params_from_jax(jparams, "cpu")
    from repro_torch.launch.serve import make_prefill_step, make_serve_step

    pre = make_prefill_step(cfg, plan=plan, device="cpu")(params, {"tokens": toks})
    grown = registry.init_cache(cfg, B, S + DECODE, device="cpu")
    for dst, src in zip(pytree.tree_leaves(grown), pytree.tree_leaves(pre["caches"])):
        dst.narrow(-3, 0, src.shape[-3]).copy_(src)
    step = make_serve_step(cfg, plan=plan, device="cpu")
    out, tok = [], nxt
    for t in range(DECODE):
        o, grown = step(params, tok, grown, S + t)
        out.append({k: v.numpy() for k, v in o.items()})
        tok = o["token"][:, None].numpy()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results for every job at each world size, and the
    reference's inputs."""
    d = tmp_path_factory.mktemp("tp_ssm")
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


def _whole_elements(spec, shape, mesh):
    """A boolean array over a rank's slice of `shape` under `spec`: True on
    the elements every model rank holds whole (all of a replicated leaf,
    the whole blocks of a packed dim), False on this rank's blocks."""
    local = sharding.local_shape(shape, spec, mesh)
    dim, blocks = sharding.model_parts(spec, local, mesh)
    line = np.concatenate([np.full(n, not split) for n, split in blocks])
    return np.broadcast_to(line.reshape((-1,) + (1,) * (len(local) - dim - 1)), local)


# ------------------------------------------------------------------- tests
def test_mesh_layout(ranks):
    outs, _ = ranks
    for w, (data, model) in WORLDS.items():
        got = sorted(o["coords"] for o in outs[w])
        assert got == [(i, j) for i in range(data) for j in range(model)], got
        assert all(o["backend"] == "gloo" and o["shape"] == (data, model) for o in outs[w])


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_layout_cut_is_the_one_device_slice(ranks, world, name):
    """init_params(mesh=) and params_from_jax(mesh=) give each rank, bit for
    bit, its cut of the one-device params under the layout, and
    `gather_whole` gives the whole tree back. The packed leaves are cut by
    hand too: the rank's heads' z, x and dt columns of ``in_proj``, its x
    channels of ``conv_w`` / ``conv_b``, then B and C whole; a layer whose
    heads the axis does not divide is whole."""
    outs, ref = ranks
    cfg = _cfgs(name)[1]
    full = transformer.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    jfull = transformer.params_from_jax(ref[name][1], "cpu")
    model = WORLDS[world][1]
    di, h, gn2 = cfg.d_inner, cfg.ssm_heads, 2 * cfg.ssm_n_groups * cfg.ssm_state
    split = h % model == 0
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
        whole = {sharding.path_str(p): a.numpy() for p, a in
                 pytree.tree_flatten_with_path(full)[0]}
        k, hk = di // model, h // model
        for path in [p for p in whole if p.endswith("mamba/in_proj")]:
            base = path[:-len("in_proj")]
            w, got_w = whole[path], got["init"][path]
            if not split:
                for leaf in ("in_proj", "conv_w", "conv_b", "A_log", "out_proj", "norm_scale"):
                    np.testing.assert_array_equal(got["init"][base + leaf], whole[base + leaf])
                continue
            cols = [w[..., m * k:(m + 1) * k], w[..., di + m * k:di + (m + 1) * k],
                    w[..., 2 * di:2 * di + gn2]]
            if not cfg.mamba_split_proj:
                cols.append(w[..., 2 * di + gn2 + m * hk:2 * di + gn2 + (m + 1) * hk])
            else:
                np.testing.assert_array_equal(got["init"][base + "dt_proj"],
                                              whole[base + "dt_proj"])
            np.testing.assert_array_equal(got_w, np.concatenate(cols, -1), err_msg=path)
            for leaf in ("conv_w", "conv_b"):
                c = whole[base + leaf]
                np.testing.assert_array_equal(
                    got["init"][base + leaf],
                    np.concatenate([c[..., m * k:(m + 1) * k], c[..., di:]], -1))
            np.testing.assert_array_equal(got["init"][base + "A_log"],
                                          whole[base + "A_log"][..., m * hk:(m + 1) * hk])
            np.testing.assert_array_equal(got["init"][base + "out_proj"],
                                          whole[base + "out_proj"][..., m * k:(m + 1) * k, :])


@pytest.mark.parametrize("world", list(WORLDS))
def test_cache_layout(ranks, world):
    """The decode caches a rank allocates: its batch rows, its SSD heads'
    state and conv channels with B and C whole; the attention layers' kv
    heads split as `cache_specs_tree` splits them."""
    outs, ref = ranks
    model = WORLDS[world][1]
    for name in CONFIGS:
        cfg = _cfgs(name)[1]
        h, ph, gn2 = cfg.ssm_heads, cfg.ssm_head_dim, 2 * cfg.ssm_n_groups * cfg.ssm_state
        hl = h // model if h % model == 0 else h
        for path, shape in outs[world][0][name]["cache"].items():
            if path.endswith("ssd"):
                assert shape[-3:] == (hl, ph, cfg.ssm_state), (name, path, shape)
            elif path.endswith("conv"):
                assert shape[-2:] == (cfg.ssm_conv - 1, hl * ph + gn2), (name, path, shape)
            else:
                assert shape[-2] == cfg.num_kv_heads // model, (name, path, shape)


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_serve_steps_match_reference(ranks, world, name):
    """The prefill step's logits, exit confidences and predictions, four
    decode steps from fresh caches (each rank's vocab shard of the
    logits, the global argmax) against the reference's jitted steps on
    one device, and four steps decoded from the prefill's own caches
    against the port's one-device run."""
    outs, ref = ranks
    want = _reference(name, ref)
    n_ex = len(_cfgs(name)[1].exit_layers)
    decided = 0
    for out in outs[world]:
        got = out[name]["prefill"]
        np.testing.assert_allclose(got["logits"], want["prefill"]["logits"], **TOL)
        np.testing.assert_allclose(got["exit_confidence"], want["prefill"]["exit_confidence"],
                                   **TOL)
        for i in range(n_ex):
            decided += _decided(got["exit_prediction"][i], want["prefill"]["exit_prediction"][i],
                                want["prefill_exit_logits"][i], TEMPS[i])
        for t in range(DECODE):
            w, o = want["decode"][t], out[name]["decode"][t]
            n_v = o["logits"].shape[-1]
            lo = 0 if n_v == w["logits"].shape[-1] else out["coords"][1] * n_v
            np.testing.assert_allclose(o["logits"], w["logits"][:, lo:lo + n_v], **TOL)
            np.testing.assert_allclose(o["exit_confidence"], w["exit_confidence"], **TOL)
            for i in range(n_ex):
                decided += _decided(o["exit_prediction"][i], w["exit_prediction"][i],
                                    want["decode_exit_logits"][t][i], TEMPS[i])
            decided += _decided(o["token"], w["token"], w["logits"], 1.0)
    assert decided >= len(outs[world]) * B * (1 + DECODE)
    one = _port_resume(name, ref)
    for out in outs[world]:
        for t, (o, w) in enumerate(zip(out[name]["resume"], one)):
            n_v = o["logits"].shape[-1]
            lo = 0 if n_v == w["logits"].shape[-1] else out["coords"][1] * n_v
            np.testing.assert_allclose(o["logits"], w["logits"][:, lo:lo + n_v], **TOL)
            np.testing.assert_allclose(o["exit_confidence"], w["exit_confidence"], **TOL)
            _decided(o["token"], w["token"], w["logits"], 1.0)


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("level", [0, 1, 2])
def test_lm_engine_over_the_mesh(ranks, world, level):
    """lm_engine(mesh=) on the jamba smoke at codec levels 0/1/2: every
    rank's decisions and on-device predictions equal the reference's
    one-device engine, and payload_bytes are one device's."""
    outs, ref = ranks
    cfg, jparams, toks = ref[ENGINE][:3]
    jobs_plan = JPlan.from_json(_engine_plan(ref, level))
    jeng = jlm_engine(jparams, cfg, jobs_plan)
    want = jeng.infer({"tokens": jnp.asarray(toks)})
    on = want["on_device"]
    assert 0 < on.sum() < len(on)
    for out in outs[world]:
        got = out[ENGINE]["engine"][level]
        np.testing.assert_array_equal(got["on_device"], on)
        np.testing.assert_array_equal(got["prediction"][on], want["prediction"][on])
        np.testing.assert_allclose(got["confidence"][on], want["confidence"][on], **TOL)
        assert got["payload_bytes"] == jeng.stats.payload_bytes
        assert got["offloaded"] == int((~on).sum())


def _engine_plan(ref, level):
    cfg, jparams, toks = ref[ENGINE][:3]
    z = jtr.edge_forward(jparams, cfg, {"tokens": jnp.asarray(toks)})["exit_logits"][:, 0]
    conf = np.sort(np.asarray(jax.nn.softmax(np.asarray(z) / TEMPS[0], axis=-1).max(-1)))
    p_tar = float(conf[B // 2 - 1] + conf[B // 2]) / 2
    return _plan(p_tar).with_compression(level).to_json()


def _close_leaves(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"], atol=TOL["atol"] * np.abs(w).max(),
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_gradients_match_reference(ranks, world, name):
    """The loss, its metrics and every gradient leaf (a rank's blocks
    gathered whole, a packed leaf's by its blocks) on every rank against
    the reference's ``jax.value_and_grad(loss_fn)`` on one device; the
    replicated elements of the gradients (the B and C columns and
    channels of the packed leaves, ``dt_proj``, the norms, the router)
    bit-equal over the model ranks."""
    outs, ref = ranks
    want = _reference(name, ref)
    for out in outs[world]:
        got = out[name]
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, err_msg=k, **TOL)
        _close_leaves(got["grads"], want["grads"], f"{name} grads")
    _same_whole_elements(outs[world], world, name, "local_grads")


def _same_whole_elements(outs, world, name, key):
    """Every element all model ranks hold whole is the same bit for bit on
    every rank; returns how many a rank holds."""
    cfg = _cfgs(name)[1]
    by_path = loop.whole_specs(cfg, make_debug_mesh(*WORLDS[world]))
    whole = {sharding.path_str(p): tuple(a.shape) for p, a in
             pytree.tree_flatten_with_path(registry.param_specs_shapes(cfg))[0]}
    first = outs[0][name][key]
    mesh = _rank_mesh(world, outs[0]["coords"])
    n = 0
    for path, spec in by_path.items():
        mask = _whole_elements(spec, whole[path], mesh)
        n += int(mask.sum())
        for out in outs[1:]:
            np.testing.assert_array_equal(out[name][key][path][mask], first[path][mask],
                                          err_msg=f"{name} {key} {path}")
    assert n > 0
    return n


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_steps_match_reference(ranks, world, name):
    """Three AdamW steps (remat, the in-place update, the global norm over
    the packed leaves): every step's losses, ``grad_norm`` and learning
    rate, and the parameters after them, gathered whole, against the
    reference's jitted `train_step`; the replicated elements the same on
    every rank after them."""
    outs, ref = ranks
    want = _reference(name, ref)
    assert want["steps"][0]["grad_norm"] > 1.0  # the clip acts
    for out in outs[world]:
        got = out[name]
        for t, (g, w) in enumerate(zip(got["steps"], want["steps"])):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], err_msg=f"step {t} {k}", **TOL)
        for i, (g, w) in enumerate(zip(got["params"], want["params"])):
            np.testing.assert_allclose(g, w, err_msg=f"{name} param {i}", **TOL)
    _same_whole_elements(outs[world], world, name, "local_after")


@pytest.mark.parametrize("world", list(WORLDS))
def test_moe_dropped_counts_equal_one_device(ranks, world):
    """The jamba smoke's MoE layers drop the same (token, slot) pairs on
    every rank as the port on one device, in the prefill and in the
    train step's forward."""
    outs, ref = ranks
    cfg = _cfgs("jamba")[1]
    _, jparams, toks, _, batches = ref["jamba"]
    params = transformer.params_from_jax(jparams, "cpu")
    got, tap = [], transformer.apply_moe

    def tapped(p, c, x):
        y, aux = tap(p, c, x)
        got.append(float(aux["moe_dropped_frac"]))
        return y, aux

    transformer.apply_moe = tapped
    try:
        transformer.forward_prefill(params, cfg, {"tokens": torch.as_tensor(toks)})
        pre = list(got)
        got.clear()
        loop.make_grad_fn(cfg, device="cpu")(params, batches[0])
    finally:
        transformer.apply_moe = tap
    slots = B * S * cfg.moe_top_k
    counts = [round(v * slots) for v in pre]
    assert sum(counts) > 0  # tokens drop
    for out in outs[world]:
        assert [round(v * slots) for v in out["jamba"]["drops"]] == counts
        assert ([round(v * slots) for v in out["jamba"]["train_drops"]]
                == [round(v * slots) for v in got])


@pytest.mark.parametrize("world", list(WORLDS))
def test_mesh_checkpoint_is_the_reference_file(ranks, world):
    """The ranks' checkpoint of their slices, packed leaves included,
    written by rank 0, loads in the reference's `checkpoint.load` as the
    one-device params bit for bit, and each rank's mesh load gives back
    its own slices."""
    outs, ref = ranks
    jparams = ref["mamba"][1]
    got = outs[world][0]["mamba"]
    loaded = jcheckpoint.load(got["ckpt"], jparams)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert all(out["mamba"]["ckpt_back"] for out in outs[world])


def test_collectives_of_a_step_by_pass(ranks):
    """The mamba smoke's gradient pass at (1, 2), worked out by hand.
    Forward: the embedding's all-reduce, two a layer (the rows' sums of
    squares, out_proj's float32 partials), two a head for the
    vocab-parallel loss. Backward: five a layer (the sums of squares'
    gradient, the block input's, and the B/C blocks of in_proj, conv_w and
    conv_b), one a head. The recompute of the checkpointed layers reruns
    the sums of squares, which the norm's saved tensors need; out_proj's
    reduce feeds nothing saved."""
    outs, ref = ranks
    cfg = ref["mamba"][0]
    L, heads, d = cfg.num_layers, 1 + len(cfg.exit_layers), cfg.d_model
    gn2, ck = 2 * cfg.ssm_n_groups * cfg.ssm_state, cfg.ssm_conv
    rows = B * S
    passes = outs[2][0]["mamba"]["passes"]
    assert passes["forward"]["counts"] == {"all-reduce": 1 + 2 * L + 2 * heads}
    assert passes["backward"]["counts"] == {"all-reduce": 5 * L + heads}
    assert passes["recompute"]["counts"] == {"all-reduce": L}
    assert passes["backward"]["bytes"] == {"all-reduce": 4 * (
        L * (rows + rows * d + d * gn2 + ck * gn2 + gn2) + heads * rows * d)}


def test_global_norm_over_a_packed_leaf():
    """A packed leaf's split blocks are summed over the model ranks and its
    whole blocks counted once: on a described rank the split blocks' sum
    goes into the one logged all-reduce and the whole one is added after;
    a leaf that is one whole block is counted as before."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(3, 10, generator=g)  # local blocks: 4 split, 2 whole, 4 split
    v = torch.randn(5, generator=g)
    flags = [(1, ((4, True), (2, False), (4, True))), (0, ((5, False),))]
    with record_collectives() as log:
        got = optim.global_norm({"a": w, "b": v}, (flags, None))
    assert log.counts == {"all-reduce": 1} and log.bytes == {"all-reduce": 8}
    torch.testing.assert_close(got, optim.global_norm({"a": w, "b": v}))
    # over two ranks the same local leaves give split blocks twice, whole once
    mesh = make_debug_mesh(1, 2)
    spec = (None, sharding.Packed(((8, "model"), (2, None), (8, "model"))))
    assert sharding.model_parts(spec, (3, 10), mesh) == flags[0]
    assert sharding.model_parts((), (5,), mesh) == flags[1]
    assert sharding.model_parts(("model",), (4,), mesh) == (0, ((4, True),))
    assert sharding.local_shape((3, 18), spec, mesh) == (3, 10)
    assert sharding.whole_shape((3, 10), spec, mesh) == (3, 18)
    assert sharding.shard_bytes(torch.empty(3, 18), spec, mesh) == 3 * 10 * 4


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
def test_dryrun_collectives_on_a_model_axis(mesh, shape):
    """The mamba2 smoke's steps (2 layers, exit after layer 0, bf16, 16 SSD
    heads) traced as rank 0 of a (data, model) mesh, their collectives
    worked out by hand: the vocab-parallel embedding's all-reduce (bf16),
    two a layer (the rows' float32 sums of squares, out_proj's float32
    partials), the final and exit logits' vocab gathers (model blocks of
    (b, 1, V / model), bf16) and with a data axis the outputs' gathers over
    it; decode also gathers each shard's (max, argmax) in float64. A train
    step adds two a head for the loss and the global norm's (and with a
    data axis the means of the gradients and metrics over it), five a
    layer backward and the heads' inputs, and the recompute's sums of
    squares."""
    cfg = get_smoke("mamba2-130m")
    sh = INPUT_SHAPES[shape]
    data, model = (int(n) for n in mesh.split("x"))
    L, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    gn2, ck = 2 * cfg.ssm_n_groups * cfg.ssm_state, cfg.ssm_conv
    bl = sh.global_batch // data
    rows = bl * (1 if sh.kind == "decode" else sh.seq_len)
    counts = 1 + 2 * L
    nbytes = rows * d * 2 + L * (rows * 4 + rows * d * 4)
    if sh.kind == "prefill":
        counts += 2
        nbytes += 2 * model * bl * (V // model) * 2
        if data > 1:
            counts += 3
            nbytes += data * bl * V * 2 + 2 * data * bl * 4
    elif sh.kind == "decode":
        counts += 2
        nbytes += model * bl * (V // model) * 2 + model * bl * 2 * 8
        if data > 1:
            counts += 4
            nbytes += data * bl * 4 + data * bl * (V // model) * 2 + 2 * data * bl * 4
    r = dryrun.run_one("mamba2-130m", shape, None, mesh=mesh, device="cpu", smoke=True)
    assert r["traced_as"] == "rank 0" and "collectives_note" not in r
    if sh.kind == "train":
        heads = 1 + len(cfg.exit_layers)
        passes = r["collective_passes"]
        # with a data axis the means over it: the gradients, one bucket a
        # dtype (bf16 and float32 leaves), and the metrics
        assert passes["forward"]["counts"] == {
            "all-reduce": counts + 2 * heads + 1 + (3 if data > 1 else 0)}
        assert passes["backward"]["counts"] == {"all-reduce": 5 * L + heads}
        assert passes["recompute"]["counts"] == {"all-reduce": L}
        assert passes["backward"]["bytes"] == {"all-reduce": 4 * (
            L * (rows + rows * d + d * gn2 + ck * gn2 + gn2) + heads * rows * d)}
    else:
        assert r["collective_counts"] == {"all-reduce": counts}
        assert r["collective_bytes"] == {"all-reduce": nbytes}
    # the traced params are rank 0's: the layout's per-card bytes
    assert r["memory"]["params_bytes"] == r["per_card_bytes"]["params"]


def test_layout_is_the_reference_specs_but_the_packed_leaves():
    """`layout_specs` equals `param_specs` (the reference's) on every leaf
    but mamba's packed ones where the axis divides the heads, and makes
    every leaf of a mamba layer whole where it does not (mamba2-130m's 24
    heads over 16 ranks, jamba's 128 over 16 split)."""
    for arch, model, split in (("mamba2-130m", 2, True), ("mamba2-130m", 16, False),
                               ("jamba-v0.1-52b", 16, True)):
        whole = registry.param_specs_shapes(get_smoke(arch) if model == 2 else get_config(arch))
        mesh = make_debug_mesh(16 // model if model < 16 else 1, model)
        specs = sharding.specs_by_path(whole, mesh)
        ref_specs = {sharding.path_str(p): s for p, s in pytree.tree_flatten_with_path(
            sharding.param_specs(whole, mesh), is_leaf=lambda x: isinstance(x, tuple))[0]}
        for path, spec in specs.items():
            if "/mamba/" not in path:
                assert spec == ref_specs[path], path
            elif not split:
                assert spec == (), path
            elif path.endswith(("in_proj", "conv_w", "conv_b")):
                assert isinstance(spec[-1], sharding.Packed), path
            elif path.endswith("dt_proj"):
                assert spec == (), path
            else:
                assert spec == ref_specs[path], path


def test_checks_admit_the_ssm_and_hybrid_families():
    """The entry points admit mamba2-130m, jamba-v0.1-52b and whisper-base
    (and their smokes) at a model axis above one: the serve, train and
    eval steps build, and each smoke's sharded init gives rank 0 of the
    mesh its slices (whisper's heads split, its 512-token vocabulary
    too)."""
    from repro_torch.launch.serve import make_prefill_step, make_serve_step

    mesh = make_debug_mesh(1, 4).as_rank()
    for arch in ("mamba2-130m", "jamba-v0.1-52b", "whisper-base"):
        for cfg in (get_config(arch), get_smoke(arch)):
            for make in (make_prefill_step, make_serve_step, loop.make_eval_step):
                assert callable(make(cfg, device="cpu", mesh=mesh)), (cfg.name, make)
            assert callable(loop.make_train_step(cfg, optim.AdamWConfig(), device="cpu",
                                                 mesh=mesh))
        p = registry.init_params(torch.Generator().manual_seed(0), get_smoke(arch), "cpu",
                                 mesh=mesh)
        whole = registry.init_params(torch.Generator().manual_seed(0), get_smoke(arch), "cpu")
        assert transformer.num_params(p) < transformer.num_params(whole), arch
    w = get_smoke("whisper-base")
    assert p["dec_blocks"][0]["cross_attn"]["wq"].shape[1] == w.num_heads // 4
    assert p["lm_head"]["w"].shape[1] == w.vocab_size // 4
