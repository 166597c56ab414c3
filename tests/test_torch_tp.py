"""Tensor parallelism on a model axis (`launch.mesh.join_ranks(model=)`,
`sharding.local_shards`, `transformer.init_params(mesh=)` /
`params_from_jax(mesh=)`, `registry.init_cache(mesh=)`, the serve steps
and `lm_engine` with ``mesh=``, the MoE experts split over the axis, and the
dry run's collective schedule) against the reference's one-device
functions and the port's own one-device run.

Gloo ranks on the CPU, launched once per world size with ``python -m
torch.distributed.run --standalone`` in a subprocess: two ranks as a
(data 1, model 2) mesh and four as (data 2, model 2). Every rank gets the
same global batch and the reference's seeded params (`params_from_jax`
with constant leaves redrawn, so biases and norm scales have teeth) and
keeps its slices; the reference runs the same params on one device under
`jax.jit` while the ranks run.

Tolerances, as tests/test_torch_lm_serve.py: logits and confidences
rtol / atol 2e-4 (float32 configs); predictions equal where the
reference's top-2 gap clears twice that; gate decisions equal away from
p_tar +- 1e-6 (ROADMAP hazard d); dropped (token, slot) counts and
`payload_bytes` equal; the sharded init bit for bit.
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
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models import transformer as jtr
from repro.offload.engine import lm_engine as jlm_engine
from repro_torch import sharding
from repro_torch.configs import get_smoke
from repro_torch.core.calibration import TemperatureScaling
from repro_torch.core.policy import OffloadPlan
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.serve import make_prefill_step, make_serve_step
from repro_torch.models import registry, transformer
from repro_torch.offload.engine import lm_engine

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = dict(rtol=2e-4, atol=2e-4)
BOUNDARY = 1e-6
B, S, DECODE = 4, 8, 4
TEMPS = [1.3, 0.8]
WORLDS = {2: (1, 2), 4: (2, 2)}  # ranks -> (data, model)

WORKER = textwrap.dedent('''
    import pickle, sys
    import numpy as np, torch
    import torch.utils._pytree as pytree
    from repro_torch import sharding
    from repro_torch.core.policy import OffloadPlan
    from repro_torch.launch.mesh import join_ranks, record_collectives
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.models import moe, registry, transformer
    from repro_torch.offload.engine import lm_engine

    mesh, backend = join_ranks("cpu", model=2)
    with open(sys.argv[1], "rb") as f:
        jobs = pickle.load(f)
    B, S, DECODE = jobs.pop("sizes")
    gen = lambda: torch.Generator().manual_seed(0)
    leaves = lambda tree: [a.numpy() for a in pytree.tree_leaves(tree)]
    drops = []
    apply_moe = transformer.apply_moe

    def tapped(p, cfg, x):
        y, aux = apply_moe(p, cfg, x)
        drops.append(float(aux["moe_dropped_frac"]))
        return y, aux

    transformer.apply_moe = tapped
    out = {"backend": backend, "coords": (mesh.coordinate("data"), mesh.coordinate("model")),
           "shape": mesh.shape}
    for name, job in jobs.items():
        cfg = job["cfg"]
        if name == "init":
            out[name] = {"init": leaves(transformer.init_params(gen(), cfg, "cpu", mesh=mesh)),
                         "jax": leaves(transformer.params_from_jax(job["params"], "cpu",
                                                                   mesh=mesh))}
            continue
        params = transformer.params_from_jax(job["params"], "cpu", mesh=mesh)
        if name.endswith("_layer"):
            x = torch.from_numpy(job["x"])
            p = transformer.params_from_jax({"moe": job["moe"]}, "cpu", mesh=mesh)["moe"]
            split = sharding.data_split(mesh)
            lo, hi = 0, len(x)
            if split is not None:
                lo, hi = split[1] * len(x) // split[2], (split[1] + 1) * len(x) // split[2]
            with sharding.use_mesh(mesh), moe.data_parallel(*(split or (None, 0, 1))):
                y, aux = moe.apply_moe(p, cfg, x[lo:hi])
            out[name] = {"y": y.numpy(), "lo": lo, "hi": hi, "w_up": tuple(p["w_up"].shape),
                         "aux": {k: float(v) for k, v in aux.items()}}
            continue
        plan = OffloadPlan.from_json(job["plan"])
        res = {"local": {sharding.path_str(p): tuple(a.shape)
                         for p, a in pytree.tree_flatten_with_path(params)[0]}}
        drops.clear()
        with record_collectives() as log:
            pre = make_prefill_step(cfg, plan=plan, mesh=mesh)(params, {"tokens": job["tokens"]})
        res["prefill"] = {k: pre[k].numpy() for k in ("logits", "exit_confidence",
                                                      "exit_prediction")}
        res["prefill_collectives"] = (dict(log.counts), dict(log.bytes))
        res["drops"] = list(drops)
        step = make_serve_step(cfg, plan=plan, mesh=mesh)
        caches = registry.init_cache(cfg, B, DECODE, device="cpu", mesh=mesh)
        res["cache"] = [tuple(a.shape) for a in pytree.tree_leaves(caches)]
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


def _plan(p_tar=0.5):
    return OffloadPlan(p_tar=p_tar,
                       calibrators=[TemperatureScaling.from_temperature(t) for t in TEMPS])


CONFIGS = {
    # exits after layers 0 and 2 of 4: a one-layer segment, a stacked one
    "dense": ("qwen2-72b", dict(num_layers=4, exit_layers=(0, 2))),
    # one kv head and an odd vocabulary: fit_spec leaves wk/wv/bk/bv, the
    # embedding and every head whole at model = 2
    "kv1": ("qwen2-72b", dict(num_layers=3, exit_layers=(0, 1), num_kv_heads=1,
                              vocab_size=511)),
    # E = 4 over 2 model ranks, top-2, capacity factor 0.5: tokens drop
    "moe": ("granite-moe-3b-a800m", dict(num_layers=2, exit_layers=(0, 1),
                                         moe_capacity_factor=0.5)),
    # experts padded 4 -> 16: rank 1's 8 experts are all padding
    "moe_pad": ("granite-moe-3b-a800m", dict(num_layers=2, exit_layers=(0, 1),
                                             moe_capacity_factor=0.5, moe_shard_capacity=True)),
}


def _jobs():
    jobs, ref = {"sizes": (B, S, DECODE)}, {}
    rng = np.random.default_rng(7)
    for i, (name, (arch, kw)) in enumerate(CONFIGS.items()):
        jcfg = jget_smoke(arch).replace(dtype="float32", **kw)
        jparams = jax.tree.map(np.asarray, _redraw_constants(
            jregistry.init_params(jax.random.PRNGKey(i), jcfg), seed=i))
        toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        nxt = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jobs[name] = dict(cfg=get_smoke(arch).replace(dtype="float32", **kw), params=jparams,
                          tokens=toks, next=nxt, plan=_plan().to_json())
        ref[name] = (jcfg, jparams, toks, nxt)
    jcfg, jparams, toks, _ = ref["dense"]
    jobs["init"] = dict(cfg=jobs["dense"]["cfg"], params=jparams)
    # lm_engine: exit 0 at T 1.3, p_tar between the two middle calibrated
    # confidences of the reference's edge, so both outcomes occur
    z = jtr.edge_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})["exit_logits"][:, 0]
    conf = np.sort(np.asarray(jax.nn.softmax(np.asarray(z) / TEMPS[0], axis=-1).max(-1)))
    p_tar = float(conf[B // 2 - 1] + conf[B // 2]) / 2
    jobs["dense"]["engine"] = {lv: _plan(p_tar).with_compression(lv).to_json()
                               for lv in (0, 1, 2)}
    for name in ("moe", "moe_pad"):
        jcfg = ref[name][0]
        mp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(5), jcfg))
        x = np.random.default_rng(6).standard_normal((2 * B * S, jcfg.d_model)).astype(np.float32)
        jobs[f"{name}_layer"] = dict(cfg=jobs[name]["cfg"], params=jobs[name]["params"],
                                     moe=mp, x=x)
        ref[f"{name}_layer"] = (jcfg, mp, x)
    return jobs, ref


_REF = {}


def _reference(name, ref):
    if name not in _REF:
        _REF[name] = _compute_reference(name, *ref[name])
    return _REF[name]


def _compute_reference(name, cfg, params, toks, nxt=None):
    if name.endswith("_layer"):
        y, aux = jax.jit(lambda p, x: jmoe.apply_moe(p, cfg, x))(params, jnp.asarray(toks))
        return {"y": np.asarray(y), "aux": {k: float(v) for k, v in aux.items()}}
    jplan = JPlan.from_json(_plan().to_json())
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
    return out


def _port_one_device(name, ref):
    """The port's one-device prefill and resumed decode on the same params."""
    cfg, jparams, toks, nxt = ref[name]
    tcfg = get_smoke(CONFIGS[name][0]).replace(dtype="float32", **CONFIGS[name][1])
    params = transformer.params_from_jax(jparams, "cpu")
    pre = make_prefill_step(tcfg, plan=_plan(), device="cpu")(params, {"tokens": toks})
    grown = registry.init_cache(tcfg, B, S + DECODE, device="cpu")
    for dst, src in zip(pytree.tree_leaves(grown), pytree.tree_leaves(pre["caches"])):
        dst.narrow(-3, 0, src.shape[-3]).copy_(src)
    step = make_serve_step(tcfg, plan=_plan(), device="cpu")
    out, tok = [], nxt
    for t in range(DECODE):
        o, grown = step(params, tok, grown, S + t)
        out.append({k: v.numpy() for k, v in o.items()})
        tok = o["token"][:, None].numpy()
    return {k: pre[k].numpy() for k in ("logits", "exit_confidence", "exit_prediction")}, out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results for every job at each world size, and the
    reference's inputs."""
    d = tmp_path_factory.mktemp("tp")
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


def _decided(got_pred, want_pred, want_logits, temp):
    """Predictions equal wherever the reference's top-2 gap of z/T clears
    twice the logits' tolerance; returns how many rows that is."""
    z = np.asarray(want_logits, np.float32) / temp
    top2 = np.sort(z, axis=-1)[..., -2:]
    tol = 2 * (TOL["atol"] + TOL["rtol"] * np.abs(top2[..., 1])) / temp
    clear = (top2[..., 1] - top2[..., 0]) > tol
    np.testing.assert_array_equal(np.asarray(got_pred)[clear], np.asarray(want_pred)[clear])
    return int(clear.sum())


# ------------------------------------------------------------------- tests
def test_mesh_layout(ranks):
    outs, _ = ranks
    for w, (data, model) in WORLDS.items():
        got = sorted(o["coords"] for o in outs[w])
        assert got == [(i, j) for i in range(data) for j in range(model)], got
        assert all(o["backend"] == "gloo" and o["shape"] == (data, model) for o in outs[w])


@pytest.mark.parametrize("world", list(WORLDS))
def test_sharded_init_is_the_one_device_slice(ranks, world):
    """(a) init_params(mesh=) and params_from_jax(mesh=) give each rank, bit
    for bit, its slices of the one-device params; the cut leaves are
    checked by hand too (embed rows, q heads, d_ff rows of w_down, lm_head
    columns)."""
    outs, ref = ranks
    cfg = get_smoke("qwen2-72b").replace(dtype="float32", **CONFIGS["dense"][1])
    full = transformer.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    jfull = transformer.params_from_jax(ref["dense"][1], "cpu")
    data, model = WORLDS[world]
    for out in outs[world]:
        coords = out["coords"]
        mesh = MeshSpec(("data", "model"), (data, model)).as_rank(coords)
        for what, tree in (("init", full), ("jax", jfull)):
            want = sharding.local_shards(tree, sharding.param_specs(tree, mesh), mesh)
            got = out["init"][what]
            assert len(got) == len(pytree.tree_leaves(want))
            for g, w_ in zip(got, pytree.tree_leaves(want)):
                np.testing.assert_array_equal(g, w_.numpy())
        m = coords[1]
        paths = {sharding.path_str(p): a for p, a in pytree.tree_flatten_with_path(full)[0]}
        idx = {sharding.path_str(p): i for i, (p, _) in
               enumerate(pytree.tree_flatten_with_path(full)[0])}
        V, H, F = cfg.vocab_size, cfg.num_heads, cfg.d_ff
        for path, cut in (("embed/w", lambda a: a[m * V // 2:(m + 1) * V // 2]),
                          ("lm_head/w", lambda a: a[:, m * V // 2:(m + 1) * V // 2]),
                          ("segments/1/attn/wq", lambda a: a[:, :, m * H // 2:(m + 1) * H // 2]),
                          ("segments/1/attn/bq", lambda a: a[:, m * H // 2:(m + 1) * H // 2]),
                          ("segments/0/mlp/w_down", lambda a: a[m * F // 2:(m + 1) * F // 2]),
                          ("segments/0/mlp/w_up", lambda a: a[:, m * F // 2:(m + 1) * F // 2])):
            np.testing.assert_array_equal(out["init"]["init"][idx[path]],
                                          cut(paths[path]).numpy(), err_msg=path)


def _check_prefill_and_decode(outs, want, cfg_name, n_dec_clear):
    """Every rank's prefill and fresh-cache decode against the reference's;
    returns `n_dec_clear` plus the decided exit rows of the decode."""
    temps = TEMPS
    for out in outs:
        got = out[cfg_name]["prefill"]
        np.testing.assert_allclose(got["logits"], want["prefill"]["logits"], **TOL)
        np.testing.assert_allclose(got["exit_confidence"], want["prefill"]["exit_confidence"],
                                   **TOL)
        n = sum(_decided(got["exit_prediction"][i], want["prefill"]["exit_prediction"][i],
                         want["prefill_exit_logits"][i], t) for i, t in enumerate(temps))
        assert n >= B
    for t in range(DECODE):
        w = want["decode"][t]
        for out in outs:  # each rank's vocab shard of the decode logits
            got = out[cfg_name]["decode"][t]["logits"]
            n_v = got.shape[-1]
            lo = 0 if n_v == w["logits"].shape[-1] else out["coords"][1] * n_v
            np.testing.assert_allclose(got, w["logits"][:, lo:lo + n_v], **TOL)
        for out in outs:
            o = out[cfg_name]["decode"][t]
            np.testing.assert_allclose(o["exit_confidence"], w["exit_confidence"], **TOL)
            for i, temp in enumerate(temps):
                n_dec_clear += _decided(o["exit_prediction"][i], w["exit_prediction"][i],
                                        want["decode_exit_logits"][t][i], temp)
            _decided(o["token"], w["token"], w["logits"], 1.0)
            assert o["token"].dtype == np.int32
    return n_dec_clear


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", ["dense", "kv1"])
def test_serve_steps_match_reference_one_device(ranks, world, name):
    """(b), (c) the prefill step's logits, exit confidences and predictions
    and 4 decode steps, on every rank, against the reference's one-device
    jitted steps on the same weights, and the decode resumed from the
    prefill's own caches against the port's one-device run."""
    outs, ref = ranks
    want = _reference(name, ref)
    n = _check_prefill_and_decode(outs[world], want, name, 0)
    assert n >= B * DECODE  # most rows are decided, so the check has teeth
    pre, resumed = _port_one_device(name, ref)
    for out in outs[world]:
        for k in ("logits", "exit_confidence"):
            np.testing.assert_allclose(out[name]["prefill"][k], pre[k], **TOL)
        for got, one in zip(out[name]["resume"], resumed):
            np.testing.assert_array_equal(got["token"], one["token"])
            np.testing.assert_allclose(got["exit_confidence"], one["exit_confidence"], **TOL)
            if got["logits"].shape == one["logits"].shape:
                np.testing.assert_allclose(got["logits"], one["logits"], **TOL)
            else:  # this rank's vocab shard
                n_v = got["logits"].shape[-1]
                m = out["coords"][1]
                np.testing.assert_allclose(got["logits"], one["logits"][:, m * n_v:(m + 1) * n_v],
                                           **TOL)
    local = outs[world][0][name]["local"]
    cfg = ref[name][0]
    if name == "kv1":  # the replicated leaves are whole
        assert local["segments/0/attn/wk"][-2] == cfg.num_kv_heads == 1
        assert local["embed/w"][0] == cfg.vocab_size == 511
        assert local["segments/0/attn/wq"][-2] == cfg.num_heads // 2
    else:
        assert local["segments/0/attn/wk"][-2] == cfg.num_kv_heads // 2
        assert local["embed/w"][0] == cfg.vocab_size // 2
    # the cache holds this rank's rows and kv heads
    data = WORLDS[world][0]
    kvh = cfg.num_kv_heads if name == "kv1" else cfg.num_kv_heads // 2
    assert all(c[-4:] == (B // data, DECODE, kvh, cfg.head_dim) or
               c[-4:-2] == (B // data, DECODE) for c in outs[world][0][name]["cache"])


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", ["moe", "moe_pad"])
def test_moe_experts_on_the_model_axis(ranks, world, name):
    """(d) the MoE block with its experts split over the model axis (and
    its tokens over the data axis in the 4-rank mesh) against the
    reference's block on all the tokens: outputs within 2e-4 and the
    dropped counts equal; the MoE model's prefill against the reference's
    prefill, and its dropped counts per layer equal to the one-device
    port's."""
    outs, ref = ranks
    cfg = ref[name][0]
    want = _reference(f"{name}_layer", ref)
    slots = 2 * B * S * cfg.moe_top_k
    E = 16 if name == "moe_pad" else cfg.moe_num_experts
    assert round(want["aux"]["moe_dropped_frac"] * slots) > 0  # tokens drop
    for out in outs[world]:
        got = out[f"{name}_layer"]
        assert got["w_up"][0] == E // 2
        np.testing.assert_allclose(got["y"], want["y"][got["lo"]:got["hi"]], **TOL)
        assert round(got["aux"]["moe_dropped_frac"] * slots) == round(
            want["aux"]["moe_dropped_frac"] * slots)
        np.testing.assert_allclose(got["aux"]["moe_aux_loss"], want["aux"]["moe_aux_loss"],
                                   **TOL)
    pre = _reference(name, ref)["prefill"]
    one = []
    tap = transformer.apply_moe

    def tapped(p, c, x):
        y, aux = tap(p, c, x)
        one.append(float(aux["moe_dropped_frac"]))
        return y, aux

    transformer.apply_moe = tapped
    try:
        _port_one_device(name, ref)
    finally:
        transformer.apply_moe = tap
    one = one[:cfg.num_layers]  # the prefill's layers
    for out in outs[world]:
        np.testing.assert_allclose(out[name]["prefill"]["logits"], pre["logits"], **TOL)
        tok = B * S * cfg.moe_top_k
        assert [round(v * tok) for v in out[name]["drops"][:cfg.num_layers]] == \
            [round(v * tok) for v in one]
    assert sum(round(v * B * S * cfg.moe_top_k) for v in one) > 0


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("level", [0, 1, 2])
def test_lm_engine_over_the_mesh(ranks, world, level):
    """(e) lm_engine(mesh=) at codec levels 0/1/2: every rank's decisions
    and on-device predictions equal the reference's one-device engine and
    the port's, and payload_bytes are one device's (the payload counted
    once)."""
    outs, ref = ranks
    cfg, jparams, toks, _ = ref["dense"]
    jplan = JPlan.from_json(_plan_json(ranks, level))
    jeng = jlm_engine(jparams, cfg, jplan)
    want = jeng.infer({"tokens": jnp.asarray(toks)})
    tcfg = get_smoke("qwen2-72b").replace(dtype="float32", **CONFIGS["dense"][1])
    teng = lm_engine(transformer.params_from_jax(jparams, "cpu"), tcfg,
                     OffloadPlan.from_json(_plan_json(ranks, level)), device="cpu")
    one = teng.infer({"tokens": toks})
    on = want["on_device"]
    assert 0 < on.sum() < len(on)
    for out in outs[world]:
        got = out["dense"]["engine"][level]
        np.testing.assert_array_equal(got["on_device"], on)
        np.testing.assert_array_equal(got["on_device"], one["on_device"])
        np.testing.assert_array_equal(got["prediction"][on], want["prediction"][on])
        np.testing.assert_allclose(got["confidence"], one["confidence"], **TOL)
        assert got["payload_bytes"] == jeng.stats.payload_bytes == teng.stats.payload_bytes
        assert got["offloaded"] == int((~on).sum())


def _plan_json(ranks, level):
    """The engine plan the ranks ran at `level` (p_tar from the reference's
    edge)."""
    _, ref = ranks
    cfg, jparams, toks, _ = ref["dense"]
    z = jtr.edge_forward(jparams, cfg, {"tokens": jnp.asarray(toks)})["exit_logits"][:, 0]
    conf = np.sort(np.asarray(jax.nn.softmax(np.asarray(z) / TEMPS[0], axis=-1).max(-1)))
    assert np.abs(conf - (conf[B // 2 - 1] + conf[B // 2]) / 2).min() > BOUNDARY
    p_tar = float(conf[B // 2 - 1] + conf[B // 2]) / 2
    return _plan(p_tar).with_compression(level).to_json()


def test_prefill_collectives_counted_on_the_ranks(ranks):
    """The collectives a prefill step issues on a rank are the schedule the
    dry run predicts (dense config, (1, 2): the embedding's all-reduce,
    two row-parallel all-reduces a layer, the final and the two exit
    logits' vocab gathers)."""
    outs, ref = ranks
    cfg = ref["dense"][0]
    counts, nbytes = outs[2][0]["dense"]["prefill_collectives"]
    L, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    assert counts == {"all-reduce": 1 + 2 * L + 1 + 2}
    assert nbytes == {"all-reduce": B * S * d * 4 * (1 + 2 * L) + 3 * 2 * B * V // 2 * 4}


# ------------------------------------------------------------ dry run (f)
def _smoke_collectives(kind, b, s, data, model):
    """The collectives the qwen2 smoke step (2 layers, exit after layer 0,
    bf16) issues on one rank of a (data, model) mesh, worked out by hand:
    the vocab-parallel embedding's all-reduce (bf16), two row-parallel
    all-reduces a layer (float32 partials), the final and exit logits'
    vocab gathers (model blocks of (b, 1, V / model), bf16), and with a
    data axis the outputs' gathers over it; decode also gathers each
    shard's (max, argmax) in float64 for the next token."""
    cfg = get_smoke("qwen2-72b")
    L, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    bl = b // data
    rows = bl * (s if kind == "prefill" else 1)
    counts = 1 + 2 * L + 1  # embed, row-parallel, exit gather
    nbytes = rows * d * 2 + 2 * L * rows * d * 4 + model * bl * (V // model) * 2
    if kind == "prefill":
        counts += 1
        nbytes += model * bl * (V // model) * 2
    else:
        counts += 1
        nbytes += model * bl * 2 * 8
    if data > 1:  # logits, exit conf and pred (and decode's token)
        if kind == "prefill":
            counts += 3
            nbytes += data * bl * V * 2 + 2 * data * bl * 4
        else:
            counts += 4
            nbytes += data * bl * 4 + data * bl * (V // model) * 2 + 2 * data * bl * 4
    return {"all-reduce": counts}, {"all-reduce": nbytes}


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_dryrun_collectives_on_a_model_axis(mesh, shape):
    from repro_torch.configs import INPUT_SHAPES

    r = dryrun.run_one("qwen2-72b", shape, None, mesh=mesh, device="cpu", smoke=True)
    sh = INPUT_SHAPES[shape]
    data, model = (int(n) for n in mesh.split("x"))
    counts, nbytes = _smoke_collectives(sh.kind, sh.global_batch, sh.seq_len, data, model)
    assert r["traced_as"] == "rank 0"
    assert r["collective_counts"] == counts
    assert r["collective_bytes"] == nbytes
    # the traced params are rank 0's: the specs' per-card bytes
    assert r["memory"]["params_bytes"] == r["per_card_bytes"]["params"]
    one = dryrun.run_one("qwen2-72b", shape, None, mesh="1x1", device="cpu", smoke=True)
    assert one["collective_counts"] == {} and one["collective_bytes"] == {}
    assert one["traced_as"] == "one card"
    assert r["flops"] < one["flops"]


def test_dryrun_train_on_a_model_axis_is_null_with_its_reason():
    """A train pair on a model axis is traced as rank 0 with its backward's
    and its recompute's all-reduces, the encoder-decoder (whisper) too,
    none of them null and none with a note; a data mesh counts the
    gradients' bucket all-reduce."""
    r = dryrun.run_one("qwen2-72b", "train_4k", None, mesh="1x2", device="cpu", smoke=True)
    assert r["traced_as"] == "rank 0" and r["ok"] and "collectives_note" not in r
    cfg = get_smoke("qwen2-72b")
    L, heads = cfg.num_layers, 1 + len(cfg.exit_layers)
    passes = r["collective_passes"]
    # the embedding, two row-parallel reduces a layer, two a head for the
    # loss, then the global norm's one
    assert passes["forward"]["counts"] == {"all-reduce": 1 + 2 * L + 2 * heads + 1}
    # q/k/v's and the MLP's inputs a layer, the heads' inputs
    assert passes["backward"]["counts"] == {"all-reduce": 2 * L + heads}
    assert passes["recompute"]["counts"] == {"all-reduce": L}
    assert r["collective_counts"] == {"all-reduce": sum(
        p["counts"]["all-reduce"] for p in passes.values())}
    assert r["collective_bytes"] == {"all-reduce": sum(
        p["bytes"]["all-reduce"] for p in passes.values())}
    assert r["memory"]["params_bytes"] == r["per_card_bytes"]["params"]
    m = dryrun.run_one("whisper-base", "train_4k", None, mesh="1x2", device="cpu", smoke=True)
    assert m["traced_as"] == "rank 0" and m["ok"] and "collectives_note" not in m
    w = get_smoke("whisper-base")
    Le, Ld, heads = w.encoder_layers, w.num_layers, 1 + len(w.exit_layers)
    passes = m["collective_passes"]
    # the embedding, two row-parallel reduces an encoder layer, three a
    # decoder layer (self-attention, cross-attention, MLP), two a head for
    # the loss, the global norm's
    assert passes["forward"]["counts"] == {"all-reduce": 1 + 2 * Le + 3 * Ld + 2 * heads + 1}
    # the inputs entering the split: two an encoder layer, three a decoder
    # layer, the encoder output once for every cross-attention, each head's
    assert passes["backward"]["counts"] == {"all-reduce": 2 * Le + 3 * Ld + 1 + heads}
    assert passes["recompute"]["counts"] == {"all-reduce": 2 * Ld}
    assert m["collective_counts"] == {"all-reduce": sum(
        p["counts"]["all-reduce"] for p in passes.values())}
    assert m["memory"]["params_bytes"] == m["per_card_bytes"]["params"]
    # on a data mesh the train step's bucket all-reduce is counted
    d = dryrun.run_one("qwen2-72b", "train_4k", None, mesh="2x1", device="cpu", smoke=True)
    params = d["memory"]["params_bytes"]
    assert d["collective_counts"]["all-reduce"] >= 2
    assert d["collective_bytes"]["all-reduce"] > params
