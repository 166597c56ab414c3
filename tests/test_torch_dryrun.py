"""Port parity for the dry-run tooling: the shape helpers
(`repro_torch.models.registry`), `optim.state_specs`, the step cost model
(`repro_torch.launch.hlo_cost`) and `launch.dryrun`, on the CPU.

* The shape helpers give, leaf by leaf, the reference's shapes and dtypes
  for every arch and every input shape (the port keeps B-AlexNet's conv
  kernels OIHW: the reference's HWIO (k, k, cin, cout) is compared as
  (cout, cin, k, k)).
* `state_specs` equals the reference's with ZeRO-1 on and off.
* `analyze` counts a smoke dense config's prefill step at exactly the
  analytic matmul count, and within rel 1e-3 of the reference's
  `analyze_text` on the step compiled on this CPU: the largest gap
  measured was 6.7e-4 (4 x 256 tokens), the reference counting a little
  more than the matrix products.
* The dry run traces on fake tensors: nothing is allocated and no kernel
  launched; the kernel custom ops reach their fake implementations on a
  fake ``cuda`` tensor (a whole step cannot be traced on ``cuda`` here:
  this CPU build refuses indexing on a fake ``cuda`` tensor).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as tpytree
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro import sharding as jsharding
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.launch import dryrun as jdryrun
from repro.launch.hlo_cost import analyze_text
from repro.launch.serve import make_prefill_step as jmake_prefill_step
from repro.models import registry as jregistry
from repro.training import optim as joptim
from repro_torch import sharding
from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import calib_nll, compress, exit_gate
from repro_torch.launch import dryrun, hlo_cost, mesh
from repro_torch.models import registry
from repro_torch.training import optim
from repro_torch.training.loop import make_eval_step, make_train_step

ROOT = Path(__file__).resolve().parents[1]
KERNELS = [exit_gate.KERNEL, calib_nll.KERNEL, compress.ENCODE, compress.DECODE]
CPU = torch.device("cpu")


def _jleaves(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jsharding._path_str(p): (tuple(x.shape), str(x.dtype)) for p, x in leaves}


def _tleaves(tree):
    leaves = tpytree.tree_flatten_with_path(tree)[0]
    return {sharding.path_str(p): (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in leaves}


def _all_meta(tree):
    return all(x.device.type == "meta" for x in tpytree.tree_leaves(tree))


# ------------------------------------------------------------ shape helpers
@pytest.mark.parametrize("arch", list_archs())
def test_shape_helpers_match_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    params = registry.param_specs_shapes(cfg)
    assert _all_meta(params)
    want = _jleaves(jregistry.param_specs_shapes(jcfg))
    if arch == "b_alexnet":  # HWIO -> OIHW
        want = {k: ((s[3], s[2], s[0], s[1]), d) if len(s) == 4 else (s, d)
                for k, (s, d) in want.items()}
    assert _tleaves(params) == want
    for name, shape in INPUT_SHAPES.items():
        inputs = registry.input_specs(cfg, shape)
        assert _all_meta(inputs)
        assert _tleaves(inputs) == _jleaves(jregistry.input_specs(jcfg, JSHAPES[name])), name
        if shape.kind == "decode" and arch != "b_alexnet":
            caches = registry.cache_specs(dryrun.shape_adapted_config(cfg, shape), shape)
            assert _all_meta(caches)
            jcaches = jregistry.cache_specs(
                jdryrun.shape_adapted_config(jcfg, JSHAPES[name]), JSHAPES[name])
            assert _tleaves(caches) == _jleaves(jcaches), name


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("shape,axes", [((16, 16), ("data", "model")),
                                        ((2, 16, 16), ("pod", "data", "model"))])
def test_state_specs_match_reference(zero1, shape, axes):
    from types import SimpleNamespace

    m = mesh.MeshSpec(axes, shape)
    dp = sharding.dp_axes(m)
    dp_size = sharding.axis_size(dp, m)
    try:
        jsharding.set_mesh(SimpleNamespace(axis_names=axes, devices=np.empty(shape)))
        for arch in ("qwen3-moe-30b-a3b", "jamba-v0.1-52b", "whisper-base"):
            jshapes = jregistry.param_specs_shapes(jget_config(arch))
            jstate = joptim.state_specs(jsharding.param_specs(jshapes), zero1=zero1,
                                        dp_axes=jsharding.dp_axes(), param_shapes=jshapes,
                                        dp_size=dp_size)
            shapes = registry.param_specs_shapes(get_config(arch))
            state = optim.state_specs(sharding.param_specs(shapes, m), zero1=zero1, dp_axes=dp,
                                      param_shapes=shapes, dp_size=dp_size)
            assert state.step == tuple(jstate.step) == ()
            for got, want in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
                wl = jax.tree_util.tree_flatten_with_path(
                    want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
                gl = tpytree.tree_flatten_with_path(got, is_leaf=lambda x: isinstance(x, tuple))[0]
                assert ({sharding.path_str(p): s for p, s in gl}
                        == {jsharding._path_str(p): tuple(s) for p, s in wl}), arch
            if zero1:  # the moments of every matrix land on the data axes
                assert any(e in (dp[0] if len(dp) == 1 else dp,)
                           for s in tpytree.tree_leaves(state.mu, is_leaf=lambda x: isinstance(x, tuple))
                           for e in s)
    finally:
        jsharding.set_mesh(None)


# ---------------------------------------------------------------- cost model
@pytest.mark.parametrize("b,s", [(2, 64), (4, 256)])
def test_analyze_counts_the_prefill_matmuls(b, s):
    cfg = get_smoke("qwen3-8b")
    assert cfg.family == "dense" and cfg.mlp_type == "swiglu"
    with FakeTensorMode(allow_fallback_kernels=False):
        step, args, _ = dryrun.build_step(cfg, ShapeConfig("p", s, b, "prefill"), CPU)
        got = hlo_cost.analyze(step, *args)
    d, hd, h, kvh, ff, V = (cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads,
                            cfg.d_ff, cfg.vocab_size)
    t = b * s
    layer = (2 * t * d * hd * (h + 2 * kvh) + 2 * t * h * hd * d + 3 * 2 * t * d * ff
             + 2 * 2 * b * h * s * s * hd)  # projections, swiglu, QK^T and PV
    n_exits = len(cfg.exit_layers)
    heads = 2 * b * d * V * (1 + n_exits)  # the last position's logits only
    assert got["flops"] == cfg.num_layers * layer + heads + exit_gate.FLOPS_PER_LOGIT * b * V * n_exits
    assert got["collective_bytes"] == {} and got["collective_counts"] == {}

    jcfg = jget_smoke("qwen3-8b")
    hlo = jax.jit(jmake_prefill_step(jcfg)).lower(
        jregistry.param_specs_shapes(jcfg),
        jregistry.input_specs(jcfg, type(JSHAPES["train_4k"])("p", s, b, "prefill"))
    ).compile().as_text()
    ref = analyze_text(hlo)
    assert abs(got["flops"] / ref["flops"] - 1) < 1e-3, (got["flops"], ref["flops"])
    # unfused bytes bound the reference's fusion-boundary bytes from above
    assert got["bytes"] >= ref["bytes"] > 0
    assert got["peak_bytes"] >= sum(x.numel() * x.element_size()
                                    for x in tpytree.tree_leaves(args))


def test_train_step_flops_are_three_forwards_and_remat_recomputes():
    """Without remat a train step's matmul FLOPs are 3x the forward's (the
    backward of each product is two products of its size). Remat adds the
    layers' forward once more, less each layer's last product, which
    `torch.utils.checkpoint` stops short of (nothing saved needs it), and
    holds fewer activations at its peak."""
    cfg = get_smoke("olmo-1b")
    b, s = 4, 512
    shape = ShapeConfig("t", s, b, "train")
    with FakeTensorMode(allow_fallback_kernels=False):
        params = dryrun._fake(registry.param_specs_shapes(cfg), CPU)
        batch = dryrun._fake(registry.input_specs(cfg, shape), CPU)
        fwd = hlo_cost.analyze(make_eval_step(cfg, device=CPU), params, batch)["flops"]
        plain = hlo_cost.analyze(
            make_train_step(cfg, optim.AdamWConfig(), remat=False, device=CPU, inplace=True),
            params, optim.init(params), batch)
        remat = hlo_cost.analyze(
            make_train_step(cfg, optim.AdamWConfig(), remat=True, device=CPU, inplace=True),
            params, optim.init(params), batch)
    assert plain["flops"] == 3 * fwd
    layers = fwd - (1 + len(cfg.exit_layers)) * 2 * b * s * cfg.d_model * cfg.vocab_size
    w_down = cfg.num_layers * 2 * b * s * cfg.d_ff * cfg.d_model
    assert layers - w_down <= remat["flops"] - plain["flops"] <= layers
    assert remat["peak_bytes"] < plain["peak_bytes"]


def test_live_bytes_follows_storages_and_views():
    with FakeTensorMode():
        a = torch.empty(1000, 1000)
        live = hlo_cost.LiveBytes()
        live.track(a)
        with live:
            b = a @ a
            c = b + 1
            del b
            v = c.view(-1)
            del c
            assert live.live == 8_000_000  # a, and c through its view
            del v
            assert live.live == 4_000_000
    assert live.peak == 12_000_000


def test_flop_formulas_of_the_gate_and_calibration_kernels():
    z = torch.randn(6, 37)
    y = torch.randint(0, 37, (6,), dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        exit_gate.exit_gate_kernel(z, 1.3)
    assert fc.get_total_flops() == 6 * 6 * 37
    with FlopCounterMode(display=False) as fc:
        calib_nll.calib_nll_kernel(z, y, 0.7)
    assert fc.get_total_flops() == 10 * 6 * 37


def test_kernel_ops_reach_their_fake_implementations_on_cuda():
    """A fake CUDA tensor never reaches a kernel's data_ptr(): each custom
    op returns fake outputs of the kernel's shapes and types, and counts
    no launch, no bytes beyond its own inputs and outputs."""
    before = [k.launches for k in KERNELS]
    with FakeTensorMode():
        z = torch.empty(4, 1000, dtype=torch.bfloat16, device="cuda")
        with FlopCounterMode(display=False) as fc, hlo_cost.OpBytes() as ob:
            conf, ent, idx = exit_gate.exit_gate_kernel(z, 1.3)
        assert conf.device.type == "cuda" and conf.shape == (4,) and idx.dtype == torch.int32
        assert fc.get_total_flops() == 6 * 4 * 1000 and ob.bytes == 4 * 1000 * 2 + 4 * 12
        e1, e2, zy, nll = calib_nll.calib_nll_kernel(
            z, torch.empty(4, dtype=torch.int32, device="cuda"), 0.8)
        assert nll.shape == (4,) and nll.dtype == torch.float32 and nll.device.type == "cuda"
        x = torch.empty(3, 300, device="cuda")
        enc = compress.encode(x, 2)
        assert enc.words.shape == (3, 3 * 128 * 4 // 32) and enc.words.dtype == torch.uint32
        assert enc.scales.shape == (3, 3) and enc.words.device.type == "cuda"
        out = compress.decode(enc)
        assert out.shape == (3, 300) and out.dtype == torch.float32
    assert [k.launches for k in KERNELS] == before


# ------------------------------------------------------------------ dry run
def test_run_one_on_the_cpu_records_the_step_and_the_mesh(tmp_path):
    before = [k.launches for k in KERNELS]
    r = dryrun.run_one("olmo-1b", "decode_32k", str(tmp_path), mesh="16x16", device="cpu")
    assert [k.launches for k in KERNELS] == before
    on_disk = json.loads((tmp_path / "olmo-1b__decode_32k__16x16.json").read_text())
    assert on_disk == json.loads(json.dumps(r))
    cfg = get_config("olmo-1b")
    assert r["flops"] > 0 and r["bytes_accessed"] > 0 and r["device"] == "cpu"
    assert r["model_params"] == cfg.param_count() and r["chips"] == 256
    mem = r["memory"]  # rank 0's step: its params, cache and peak
    caches = registry.cache_specs(cfg, INPUT_SHAPES["decode_32k"])
    whole = sum(x.numel() * x.element_size() for x in tpytree.tree_leaves(caches))
    assert r["traced_as"] == "rank 0"
    assert mem["peak_bytes"] >= mem["params_bytes"] + mem["cache_bytes"]
    # batch 128 over 16 data shards, 16 kv heads over 16 model shards
    assert r["per_card_bytes"]["cache"] == mem["cache_bytes"] == whole // 256
    assert r["per_card_bytes"]["params"] == mem["params_bytes"]
    assert r["fits_one_card"] == (mem["peak_bytes"] <= r["card_bytes"])


def test_dryrun_needs_a_gpu_unless_told_cpu():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_one("olmo-1b", "decode_32k", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_one("olmo-1b", "decode_32k", None, device="cuda")


def test_dryrun_subprocess_single_pair(tmp_path):
    """The twin of tests/test_system.py's dry-run test: one pair through
    the command line, on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "olmo_1b",
         "--shape", "long_500k", "--device", "cpu", "--outdir", str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("OK")
    rec = json.loads((tmp_path / "olmo_1b__long_500k__1x1.json").read_text())
    assert rec["sliding_window"] == 4096 and rec["flops"] > 0 and rec["fits_one_card"]
