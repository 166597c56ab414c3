"""The port stands alone and never falls back.

* Importing `repro_torch` and every ported module loads neither `jax` nor
  any `repro` module (checked in a subprocess: this process already
  imported jax through conftest.py).
* Entry points refuse to run when no GPU is present and no device was
  named, instead of carrying on on the CPU.
* A CPU tensor goes to a kernel's plain version and no launch is
  counted; the CUDA-only launchers refuse a CPU tensor.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.bank import fit_bank
from repro_torch.core.calibration import TemperatureScaling
from repro_torch.core.gatepath import NumpyGateBackend, get_gate_backend
from repro_torch.core.policy import OffloadPlan, make_plan
from repro_torch.kernels import calib_nll, compress, exit_gate, ops, qk_rope, ref
from repro_torch.models import convnet
from repro_torch.offload.engine import convnet_engine
from repro_torch.training import optim
from repro_torch.training.loop import make_eval_step, make_train_step

SRC = Path(__file__).resolve().parents[1] / "src"
PORTED = [
    "repro_torch",
    "repro_torch.configs",
    "repro_torch.configs.b_alexnet",
    "repro_torch.configs.base",
    "repro_torch.configs.chameleon_34b",
    "repro_torch.configs.granite_moe_3b_a800m",
    "repro_torch.configs.internlm2_20b",
    "repro_torch.configs.jamba_v01_52b",
    "repro_torch.configs.mamba2_130m",
    "repro_torch.configs.olmo_1b",
    "repro_torch.configs.qwen2_72b",
    "repro_torch.configs.qwen3_8b",
    "repro_torch.configs.qwen3_moe_30b_a3b",
    "repro_torch.configs.whisper_base",
    "repro_torch.core",
    "repro_torch.core.bank",
    "repro_torch.core.calibration",
    "repro_torch.core.control",
    "repro_torch.core.exits",
    "repro_torch.core.gatepath",
    "repro_torch.core.metrics",
    "repro_torch.core.partition",
    "repro_torch.core.policy",
    "repro_torch.data.distortion",
    "repro_torch.data.pipeline",
    "repro_torch.data.synthetic",
    "repro_torch.fleet",
    "repro_torch.fleet.compiled",
    "repro_torch.fleet.controller",
    "repro_torch.fleet.gate",
    "repro_torch.fleet.maxplus",
    "repro_torch.fleet.scenarios",
    "repro_torch.fleet.simulator",
    "repro_torch.fleet.telemetry",
    "repro_torch.fleet.topology",
    "repro_torch.kernels._build",
    "repro_torch.kernels.calib_nll",
    "repro_torch.kernels.compress",
    "repro_torch.kernels.exit_gate",
    "repro_torch.kernels.ops",
    "repro_torch.kernels.qk_rope",
    "repro_torch.kernels.ref",
    "repro_torch.launch",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.hlo_cost",
    "repro_torch.launch.mesh",
    "repro_torch.launch.serve",
    "repro_torch.launch.train",
    "repro_torch.models.attention",
    "repro_torch.models.convnet",
    "repro_torch.models.layers",
    "repro_torch.models.mamba",
    "repro_torch.models.moe",
    "repro_torch.models.registry",
    "repro_torch.models.transformer",
    "repro_torch.models.whisper",
    "repro_torch.obs",
    "repro_torch.obs.audit",
    "repro_torch.obs.calibration",
    "repro_torch.obs.calibration_report",
    "repro_torch.obs.check",
    "repro_torch.obs.export",
    "repro_torch.obs.metrics",
    "repro_torch.obs.spans",
    "repro_torch.obs.trace",
    "repro_torch.offload.engine",
    "repro_torch.offload.latency",
    "repro_torch.offload.simulator",
    "repro_torch.orchestration",
    "repro_torch.orchestration.churn",
    "repro_torch.orchestration.plane",
    "repro_torch.orchestration.qos",
    "repro_torch.orchestration.rollout",
    "repro_torch.orchestration.scenarios",
    "repro_torch.serving",
    "repro_torch.serving.controller",
    "repro_torch.serving.drift",
    "repro_torch.serving.network",
    "repro_torch.serving.runtime",
    "repro_torch.serving.scenarios",
    "repro_torch.serving.telemetry",
    "repro_torch.serving.workload",
    "repro_torch.sharding",
    "repro_torch.training.checkpoint",
    "repro_torch.training.loop",
    "repro_torch.training.losses",
    "repro_torch.training.optim",
]
KERNELS = [exit_gate.KERNEL, calib_nll.KERNEL, compress.ENCODE, compress.DECODE, qk_rope.KERNEL]


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {PORTED!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"


RANK_RUN = """\
import sys
from repro_torch.launch import train
run = train.main(['--arch', 'granite-moe-3b-a800m', '--smoke', '--steps', '2', '--batch', '2',
                  '--seq', '16', '--device', 'cpu'])
import torch.distributed as dist
assert dist.get_world_size() == 2 and len(run['step_s']) == 2
from repro_torch.fleet import CompiledFleetSimulator, CompiledGateBackend
from repro_torch.fleet.scenarios import fleet_gate_table, reference_fleet
from repro_torch.offload import latency
from repro_torch.serving.scenarios import fit_drift_plans, synthetic_distorted_cascade
val, test = synthetic_distorted_cascade(n=128, n_val=128)
_, glob, _ = fit_drift_plans(val, device='cpu')
scn = reference_fleet(n_cells=2, requests_per_cell=60, val=val, test=test)
sim = CompiledFleetSimulator(fleet_gate_table(glob.with_compression(2), scn,
                                              backend=CompiledGateBackend(device='cpu')),
                             scn.topology, latency.paper_2020())
assert sim._shard() is not None and sim.run().fleet_summary()['requests'] == 120
import numpy as np, torch
from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import join_ranks
from repro_torch.launch.serve import make_prefill_step
from repro_torch.models import registry
tp, _ = join_ranks('cpu', model=2)
cfg = get_smoke('qwen2-72b')
lm = registry.init_params(torch.Generator().manual_seed(0), cfg, device='cpu', mesh=tp)
assert lm['embed']['w'].shape[0] == cfg.vocab_size // 2
out = make_prefill_step(cfg, mesh=tp)(lm, {'tokens': np.ones((2, 8), np.int32)})
assert tuple(out['logits'].shape) == (2, 1, cfg.vocab_size)
import os
ck = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tp.msgpack')
run = train.main(['--arch', 'qwen3-8b', '--smoke', '--model', '2', '--steps', '2', '--batch', '2',
                  '--seq', '16', '--device', 'cpu', '--ckpt', ck])
assert len(run['step_s']) == 2 and run['params']['embed']['w'].shape[0] == 256
cfg = get_smoke('mamba2-130m')
lm = registry.init_params(torch.Generator().manual_seed(0), cfg, device='cpu', mesh=tp)
assert lm['segments'][0]['mamba']['A_log'].shape[-1] == cfg.ssm_heads // 2
out = make_prefill_step(cfg, mesh=tp)(lm, {'tokens': np.ones((2, 16), np.int32)})
assert tuple(out['logits'].shape) == (2, 1, cfg.vocab_size)
run = train.main(['--arch', 'mamba2-130m', '--smoke', '--model', '2', '--steps', '2',
                  '--batch', '2', '--seq', '16', '--device', 'cpu'])
assert len(run['step_s']) == 2
cfg = get_smoke('whisper-base')
lm = registry.init_params(torch.Generator().manual_seed(0), cfg, device='cpu', mesh=tp)
assert lm['dec_blocks'][0]['cross_attn']['wk'].shape[1] == cfg.num_kv_heads // 2
frames = np.zeros((2, cfg.encoder_seq, cfg.d_model), np.float32)
out = make_prefill_step(cfg, mesh=tp)(lm, {'tokens': np.ones((2, 8), np.int32),
                                           'encoder_frames': frames})
assert tuple(out['logits'].shape) == (2, 1, cfg.vocab_size)
run = train.main(['--arch', 'whisper-base', '--smoke', '--model', '2', '--steps', '2',
                  '--batch', '2', '--seq', '16', '--device', 'cpu'])
assert len(run['step_s']) == 2
assert 'jax' not in sys.modules, 'jax was imported'
bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]
assert not bad, bad
print('rank isolated')
"""


def test_running_the_fleet_and_orchestration_loads_neither_jax_nor_repro(tmp_path):
    """Importing is not enough: the reference reaches other modules through
    imports inside functions, so the port is run -- a 2-cell fleet at
    codec level 2 with every observability sink on, on the host and the
    compiled pipeline, one quick
    orchestration scenario (QoS, rollout, audit chain), the max-plus
    solvers, the LM serving path (a prefill step, a decode step and
    lm_engine at codec level 2 on a smoke config), the training driver
    (`launch.train --smoke`, with a checkpoint), a forward pass of the
    moe, mamba and whisper models, one dry-run pair on a described
    16x16 mesh with ZeRO-1, and two gloo ranks (`torch.distributed.run`)
    that each train the moe smoke data-parallel through `launch.train`,
    run a 2-cell compiled fleet sharded over cells, a tensor-parallel
    prefill of the qwen2 smoke over a model axis of two and
    `launch.train --model 2` on the qwen3 smoke with a checkpoint, then
    the same prefill and two `launch.train --model 2` steps on the mamba2
    smoke and on the whisper smoke, all on the CPU -- and only then are
    the loaded modules checked, in every process."""
    rank_script = tmp_path / "rank_run.py"
    rank_script.write_text(RANK_RUN)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from repro_torch.fleet.maxplus import fifo_done_maxplus, kserver_done_maxplus\n"
        "from repro_torch.fleet.scenarios import reference_fleet, run_fleet\n"
        "from repro_torch.obs import full_observability\n"
        "from repro_torch.orchestration import run_scenarios\n"
        "from repro_torch.serving.scenarios import fit_drift_plans, "
        "synthetic_distorted_cascade\n"
        "val, test = synthetic_distorted_cascade(n=128, n_val=128)\n"
        "_, glob, _ = fit_drift_plans(val, device='cpu')\n"
        "scn = reference_fleet(n_cells=2, requests_per_cell=60, val=val, test=test)\n"
        "obs = full_observability()\n"
        "s = run_fleet(glob.with_compression(2), scn, backend='numpy', obs=obs).fleet_summary()\n"
        "assert s['requests'] == 120 and 0 < s['offload_rate'] < 1, s\n"
        "from repro_torch.fleet import CompiledGateBackend\n"
        "c = run_fleet(glob.with_compression(2), scn, backend=CompiledGateBackend(device='cpu'),\n"
        "              obs=full_observability()).fleet_summary()\n"
        "assert c['requests'] == 120 and abs(c['p99_ms'] - s['p99_ms']) <= 1e-9 * s['p99_ms']\n"
        "(rec,) = run_scenarios(['poisoned_canary'], quick=True, device='cpu')\n"
        "assert rec['pass'], rec['wins']\n"
        "t = np.arange(8.0)\n"
        "assert fifo_done_maxplus(t, np.ones(8), device='cpu').tolist() == (t + 1).tolist()\n"
        "assert kserver_done_maxplus(t, np.ones(8), 2, device='cpu').shape == (8,)\n"
        "import torch\n"
        "from repro_torch.configs import get_smoke\n"
        "from repro_torch.core.calibration import TemperatureScaling\n"
        "from repro_torch.core.policy import OffloadPlan\n"
        "from repro_torch.launch.serve import make_prefill_step, make_serve_step\n"
        "from repro_torch.models import registry\n"
        "from repro_torch.offload.engine import lm_engine\n"
        "cfg = get_smoke('qwen3-8b')\n"
        "lm = registry.init_params(torch.Generator().manual_seed(0), cfg, device='cpu')\n"
        "plan = OffloadPlan(p_tar=0.5, calibrators=[TemperatureScaling.from_temperature(1.5)])\n"
        "toks = np.ones((2, 8), np.int32)\n"
        "out = make_prefill_step(cfg, plan=plan, device='cpu')(lm, {'tokens': toks})\n"
        "assert tuple(out['exit_confidence'].shape) == (1, 2)\n"
        "caches = registry.init_cache(cfg, 2, 8, device='cpu')\n"
        "out, _ = make_serve_step(cfg, plan=plan, device='cpu')(lm, toks[:, :1], caches, 0)\n"
        "assert tuple(out['token'].shape) == (2,)\n"
        "res = lm_engine(lm, cfg, plan.with_p_tar(2.0).with_compression(2),\n"
        "                device='cpu').infer({'tokens': toks})\n"
        "assert not res['on_device'].any() and res['prediction'].shape == (2,)\n"
        "import contextlib, io, os, tempfile\n"
        "from repro_torch.launch import train\n"
        "with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()):\n"
        "    ck = os.path.join(d, 'ck.msgpack')\n"
        "    run = train.main(['--arch', 'granite-moe-3b-a800m', '--smoke', '--steps', '2',\n"
        "                      '--batch', '2', '--seq', '16', '--device', 'cpu', '--ckpt', ck])\n"
        "    assert len(run['step_s']) == 2 and os.path.exists(ck)\n"
        "for arch in ('granite-moe-3b-a800m', 'mamba2-130m', 'jamba-v0.1-52b', 'whisper-base'):\n"
        "    c = get_smoke(arch)\n"
        "    p = registry.init_params(torch.Generator().manual_seed(0), c, device='cpu')\n"
        "    b = {'tokens': toks}\n"
        "    if c.is_encoder_decoder:\n"
        "        b['encoder_frames'] = torch.zeros(2, c.encoder_seq, c.d_model, dtype=torch.bfloat16)\n"
        "    o = registry.forward_train(p, c, b)\n"
        "    assert tuple(o['logits'].shape) == (2, 8, c.vocab_size), arch\n"
        "from repro_torch.launch import dryrun\n"
        "r = dryrun.run_one('mamba2-130m', 'long_500k', None, mesh='16x16', zero1=True,\n"
        "                   device='cpu')\n"
        "assert r['flops'] > 0 and r['fits_one_card'] and r['chips'] == 256, r\n"
        "import subprocess\n"
        "ranks = subprocess.run([sys.executable, '-m', 'torch.distributed.run', '--standalone',\n"
        f"                        '--nproc-per-node', '2', {str(rank_script)!r}],\n"
        "                       capture_output=True, text=True, timeout=240)\n"
        "assert ranks.returncode == 0, ranks.stderr[-3000:]\n"
        "assert ranks.stdout.count('rank isolated') == 2, ranks.stdout\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"


def test_fleet_and_orchestration_refuse_without_gpu(monkeypatch):
    """The fleet's entry points, the scenario matrix and the max-plus
    solvers follow the device rule: without `backend`/`device` they
    raise, and nothing launches."""
    from repro_torch.fleet import FleetController, FleetGateTable
    from repro_torch.fleet.maxplus import fifo_done_maxplus, kserver_done_maxplus
    from repro_torch.fleet.scenarios import fleet_gate_table, reference_fleet, run_fleet
    from repro_torch.offload import latency
    from repro_torch.orchestration import run_scenarios
    from repro_torch.serving.scenarios import synthetic_distorted_cascade

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    val, test = synthetic_distorted_cascade(n=64, n_val=64)
    scn = reference_fleet(n_cells=2, requests_per_cell=10, val=val, test=test)
    plan = OffloadPlan(p_tar=0.8, calibrators=[TemperatureScaling.from_temperature(1.5)] * 2)
    t = np.zeros(3)
    for call in (
        lambda: run_fleet(plan, scn),
        lambda: run_fleet(plan.with_compression(2), scn, with_controller=True),
        lambda: fleet_gate_table(plan, scn),
        lambda: FleetGateTable(test["exit_logits"], test["final"], plan),
        lambda: FleetController(plan, latency.paper_2020(), val["exit_logits"], n_cells=2,
                                final_logits=val["final"], labels=val["labels"]),
        lambda: run_scenarios(),
        lambda: run_scenarios(["link_outage"], quick=True),
        lambda: fifo_done_maxplus(t, t),
        lambda: kserver_done_maxplus(t, t, 2),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # named host paths need no device and launch nothing
    run_fleet(plan.with_compression(2), scn, with_controller=True, backend="numpy")
    fifo_done_maxplus(t, t, device="cpu")
    assert [k.launches for k in KERNELS] == [0, 0, 0, 0, 0]


def test_entry_points_refuse_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = OffloadPlan(p_tar=0.5, calibrators=[])
    params = convnet.init_params(torch.Generator().manual_seed(0), device="cpu")
    z = np.zeros((4, 10), np.float32)
    for call in (
        lambda: convnet_engine(params, plan),
        lambda: convnet.init_params(),
        lambda: make_plan([z], np.zeros(4, np.int32), p_tar=0.5),
        lambda: ops.exit_gate(z),
        lambda: ops.calib_stats(z, np.zeros(4, np.int32), 1.0),
        lambda: ops.fit_temperature_kernel(z, np.zeros(4, np.int32)),
        lambda: compress.encode(z, 1),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_training_bank_and_gates_refuse_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = convnet.init_params(torch.Generator().manual_seed(0), device="cpu")
    cfg = convnet.B_ALEXNET
    batch = {"images": np.zeros((2, 32, 32, 3), np.float32), "labels": np.zeros(2, np.int32)}
    plan = OffloadPlan(p_tar=0.5, calibrators=[TemperatureScaling.from_temperature(1.5)])
    z, y = np.zeros((4, 10), np.float32), np.zeros(4, np.int32)
    gate = get_gate_backend(None)
    for call in (
        lambda: make_train_step(cfg, optim.AdamWConfig())(params, optim.init(params), batch),
        lambda: make_eval_step(cfg)(params, batch),
        lambda: gate.plan_gate_block(plan, z),
        lambda: gate.as_table(z),
        lambda: plan.gate_block(z),
        lambda: fit_bank({"clean": [z]}, y, p_tar=0.5),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the host backend is the host path: it needs no device and finds none
    conf, _ = NumpyGateBackend().plan_gate_block(plan, z)
    assert conf.shape == (4,)
    assert [k.launches for k in KERNELS] == [0, 0, 0, 0, 0]


def test_serving_cores_and_controller_refuse_without_gpu(monkeypatch):
    """The serving runtime's cores, controller and scenarios follow the
    device rule: built without `device`/`backend`, they raise."""
    from repro_torch.offload import latency
    from repro_torch.serving import (
        ContextualLogitsCore,
        EngineCore,
        LogitsCore,
        OnlineController,
        PiecewiseSchedule,
    )
    from repro_torch.serving.scenarios import run_congested_markov, synthetic_cascade_logits

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exits, final, y = synthetic_cascade_logits(16)
    plan = OffloadPlan(p_tar=0.8, calibrators=[TemperatureScaling.from_temperature(1.0)] * 2)
    params = convnet.init_params(torch.Generator().manual_seed(0), device="cpu")
    engine = convnet_engine(params, plan, device="cpu")
    images = {"images": np.zeros((2, 32, 32, 3), np.float32)}
    for call in (
        lambda: LogitsCore(exits, final, plan, labels=y),
        lambda: ContextualLogitsCore({"clean": exits}, {"clean": final}, plan,
                                     PiecewiseSchedule([(0.0, "clean")]), labels=y),
        lambda: OnlineController(plan, latency.paper_2020(), exits, final_logits=final,
                                 labels=y),
        lambda: EngineCore({1: engine}, images),
        lambda: run_congested_markov(plan, exits, final, y, n_requests=4),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # named host paths need no device and launch nothing
    LogitsCore(exits, final, plan, labels=y, device="cpu")
    OnlineController(plan, latency.paper_2020(), exits, final_logits=final, labels=y,
                     backend="numpy")
    EngineCore({1: engine}, images, device="cpu")
    assert [k.launches for k in KERNELS] == [0, 0, 0, 0, 0]


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    before = [k.launches for k in KERNELS]
    rng = np.random.default_rng(0)
    z = torch.as_tensor(rng.standard_normal((6, 10)).astype(np.float32))
    y = torch.as_tensor(rng.integers(0, 10, 6).astype(np.int32))
    conf, pred, ent = ops.exit_gate(z, 1.5)
    rconf, rent, ridx = ref.exit_gate_ref(z, 1.5)
    assert torch.equal(conf, rconf) and torch.equal(ent, rent) and torch.equal(pred, ridx)
    got = calib_nll.calib_nll_kernel(z, y, 0.8)
    for a, b in zip(got, ref.calib_nll_ref(z, y, 0.8)):
        assert torch.equal(a, b)
    ops.fit_temperature_kernel(z, y, iters=2)
    x = torch.as_tensor(rng.standard_normal((3, 300)).astype(np.float32))
    enc = compress.encode(x, 2)
    words, scales = ref.encode_codec_ref(x, 2)
    assert torch.equal(enc.words.view(torch.int32), words.view(torch.int32))
    assert torch.equal(compress.decode(enc), ref.decode_codec_ref(words, scales, x.shape, 2))
    assert [k.launches for k in KERNELS] == before == [0, 0, 0, 0, 0]


def test_cuda_launchers_refuse_cpu_tensors():
    z = torch.zeros(4, 128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        compress.encode_kernel(z, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        compress.decode_kernel(torch.zeros(4, 32, dtype=torch.uint32), torch.zeros(4, 1), 128, 8)
    q = torch.zeros(2, 3, 4, 128)
    with pytest.raises(ValueError, match="takes CUDA"):
        qk_rope._qk_norm_rope_cuda(q, q, None, None, torch.zeros(2, 3, dtype=torch.int32), 1e4,
                                   1e-6)
    assert [k.launches for k in KERNELS] == [0, 0, 0, 0, 0]


def test_lm_serving_refuses_without_gpu(monkeypatch):
    """The LM path follows the device rule: the registry's init and cache,
    params_from_jax, the serve steps and lm_engine raise without a device,
    and run on the CPU when asked, with no launch."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.models import registry, transformer
    from repro_torch.offload.engine import lm_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("qwen3-8b")
    plan = OffloadPlan(p_tar=0.5, calibrators=[TemperatureScaling.from_temperature(1.5)])
    gen = torch.Generator().manual_seed(0)
    params = registry.init_params(gen, cfg, device="cpu")
    for call in (
        lambda: registry.init_params(None, cfg),
        lambda: registry.init_cache(cfg, 2, 8),
        lambda: transformer.params_from_jax({"w": np.zeros(3, np.float32)}),
        lambda: make_prefill_step(cfg, plan=plan),
        lambda: make_serve_step(cfg, temperatures=[1.0]),
        lambda: lm_engine(params, cfg, plan),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    toks = np.ones((2, 8), np.int32)
    make_prefill_step(cfg, plan=plan, device="cpu")(params, {"tokens": toks})
    lm_engine(params, cfg, plan, device="cpu").infer({"tokens": toks})
    assert [k.launches for k in KERNELS] == [0, 0, 0, 0, 0]


def test_lm_training_refuses_without_gpu(monkeypatch):
    """LM training follows the device rule: the train and eval steps, the
    training driver and whisper's init raise without a device, and run on
    the CPU when asked."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import train
    from repro_torch.models import registry, whisper

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("mamba2-130m")
    params = registry.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {"tokens": np.ones((2, 8), np.int32), "labels": np.ones((2, 8), np.int32)}
    for call in (
        lambda: make_train_step(cfg, optim.AdamWConfig())(params, optim.init(params), batch),
        lambda: make_eval_step(cfg)(params, batch),
        lambda: train.main(["--arch", "mamba2-130m", "--smoke", "--steps", "1"]),
        lambda: whisper.init_params(None, get_smoke("whisper-base")),
        lambda: registry.init_cache(get_smoke("whisper-base"), 1, 8),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    _, _, m = make_train_step(cfg, optim.AdamWConfig(), device="cpu")(
        params, optim.init(params), batch)
    assert torch.isfinite(m["loss"])
    assert [k.launches for k in KERNELS] == [0, 0, 0, 0, 0]


def test_lm_path_refuses_params_on_another_device(monkeypatch):
    """With a card named (here faked), a generator or params on the CPU
    raise ValueError: init draws nothing on the CPU for the card, and the
    serve steps and lm_engine move no tokens to params elsewhere."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.models import registry
    from repro_torch.offload.engine import lm_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cfg = get_smoke("qwen3-8b")
    plan = OffloadPlan(p_tar=0.5, calibrators=[TemperatureScaling.from_temperature(1.5)])
    params = registry.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = np.ones((2, 8), np.int32)
    caches = registry.init_cache(cfg, 2, 8, device="cpu")
    for call in (
        lambda: registry.init_params(torch.Generator().manual_seed(0), cfg),
        lambda: registry.init_params(torch.Generator().manual_seed(0), cfg, device="cuda"),
        lambda: make_prefill_step(cfg, plan=plan)(params, {"tokens": toks}),
        lambda: make_serve_step(cfg, plan=plan, device="cuda")(params, toks[:, :1], caches, 0),
        lambda: lm_engine(params, cfg, plan),
    ):
        with pytest.raises(ValueError, match="live on cpu, not on cuda"):
            call()
    assert [k.launches for k in KERNELS] == [0, 0, 0, 0, 0]
