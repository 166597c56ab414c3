"""One-card dry run (counterpart of `repro.launch.dryrun`): trace every
(architecture x input shape) step on fake tensors and cost it, with no
device allocation and no kernel launched.

The reference lowers and compiles each step for a TPU pod mesh and reads
XLA's memory and cost analyses. Here each pair's step -- the remat train
step with the in-place AdamW update (`training.loop.make_train_step`, as
`launch.train` runs it), or the prefill or decode step of
`launch.serve` -- runs once under `FakeTensorMode` on the chosen device
(``cuda`` by default; ``--device cpu`` traces on the CPU), with inputs
made from `models.registry`'s meta specs. Each record holds:

  * ``flops`` and ``bytes_accessed`` from `launch.hlo_cost.analyze`
    (FlopCounterMode; the unfused bytes of every op), and the roofline
    terms against the H100 SXM's 989 TFLOP/s bf16 dense and 3.35 TB/s;
  * ``memory``: the bytes of the params, the optimizer state, the decode
    cache and the batch, and the step's peak of live tensor bytes
    (`hlo_cost.LiveBytes`, which follows each storage from the op that
    made it until the last tensor on it is gone);
  * ``per_card_bytes``: the same parts as one card of the described mesh
    (``--mesh``, `launch.mesh`) would hold them under the port's layout
    (`sharding.layout_specs`, `sharding.cache_layout`: the reference's
    specs but for mamba's packed leaves) and `optim.state_specs`
    (``--zero1``);
  * ``fits_one_card``: whether the traced peak fits the card's own
    memory (`torch.cuda.get_device_properties().total_memory`; a CPU trace
    is held to the H100 SXM's 80 GB). A pair that does not fit is a
    result, not a failure.

On a mesh of more than one rank (``--mesh DxM`` or ``PxDxM``) the step
is traced as rank 0 of the described mesh (`MeshSpec.as_rank`): its
params are rank 0's `sharding.local_shards`, its batch rows and cache
rank 0's, and every collective it issues is recorded instead of issued,
so ``collective_bytes`` and ``collective_counts`` hold the step's
collective schedule and ``flops``, ``bytes_accessed`` and the memory are
one card's, as the reference's are one device's (``traced_as``:
``"rank 0"``). A train step's schedule holds its backward's all-reduces
and, with remat, the ones its checkpointed layers issue again while they
recompute; ``collective_passes`` splits the counts and bytes by pass
(forward, backward, recompute). Every LM family is traced so, the
encoder-decoder (whisper) too. On one card (``1x1``, ``traced_as``:
``"one card"``) the step issues no collective and both are empty.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu [--mesh 16x16 --zero1]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k \
      --mesh 1x2 --smoke --device cpu
Results land in build/dryrun/<arch>__<shape>__<mesh>[__<variant>[_zero1]].json.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import sharding
from repro_torch._device import resolve_device
from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke, list_archs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import MeshSpec, make_debug_mesh
from repro_torch.launch.serve import make_prefill_step, make_serve_step
from repro_torch.models import registry
from repro_torch.training import optim
from repro_torch.training.loop import make_train_step

ASSIGNED = [a for a in list_archs() if a != "b_alexnet"]

# H100 SXM (NVIDIA data sheet, dense, at its 700 W limit): the roofline terms
H100_BF16_FLOP_PER_S = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
# the memory a CPU trace is held to: the H100 SXM's 80 GB
H100_MEMORY_BYTES = 80e9


def shape_adapted_config(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """long_500k on attention-quadratic archs -> sliding-window attention.

    SSM/hybrid run natively (O(1)/bounded state). Dense/MoE/VLM/audio get a
    4096-token window so the 524k decode is sub-quadratic.
    """
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm", "audio"):
        if cfg.sliding_window == 0:
            cfg = cfg.replace(sliding_window=4096)
    return cfg


VARIANTS = {
    "baseline": {},
    "moe_shard_capacity": {"moe_shard_capacity": True},
    "decode_unroll": {"decode_unroll": True},
    "mamba_split_proj": {"mamba_split_proj": True},
    "all_opt": {
        "moe_shard_capacity": True,
        "decode_unroll": True,
        "mamba_split_proj": True,
    },
}


def parse_mesh(text: str) -> MeshSpec:
    """``DxM`` -> a (data, model) mesh; ``PxDxM`` -> (pod, data, model)."""
    sizes = tuple(int(n) for n in text.lower().split("x"))
    if len(sizes) == 2:
        return make_debug_mesh(*sizes)
    if len(sizes) == 3:
        return MeshSpec(("pod", "data", "model"), sizes)
    raise ValueError(f"--mesh takes DxM or PxDxM, got {text!r}")


def _device(device) -> torch.device:
    device = resolve_device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to trace on the CPU")
    return device


def _fake(meta_tree, device):
    """Tensors of the meta specs' shapes and dtypes on `device`: fake ones
    when called under a FakeTensorMode, as `run_one` calls it."""
    return pytree.tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype, device=device), meta_tree)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree))


def _per_card(tree, specs, mesh) -> int:
    leaves = pytree.tree_leaves(tree)
    spec_leaves = pytree.tree_leaves(specs, is_leaf=lambda x: isinstance(x, tuple))
    return sum(sharding.shard_bytes(t, s, mesh) for t, s in zip(leaves, spec_leaves))


def build_step(cfg: ModelConfig, shape: ShapeConfig, device, remat: bool = True, mesh=None):
    """The step `shape` exercises, its arguments and the state it holds
    ({part: tree}), made on `device` (a train step checkpoints its layers
    unless `remat` is off). With `mesh` (a rank of a described mesh,
    `MeshSpec.as_rank`) the params and caches are that rank's and the
    step runs over the mesh; the batch stays global, as every rank is
    handed it. Call it under a FakeTensorMode."""
    whole = registry.param_specs_shapes(cfg)
    if mesh is not None:
        whole = sharding.local_shards(whole, sharding.layout_specs(whole, mesh), mesh)
    params = _fake(whole, device)
    batch = _fake(registry.input_specs(cfg, shape), device)
    if shape.kind == "train":
        step = make_train_step(cfg, optim.AdamWConfig(), remat=remat, device=device, inplace=True,
                               mesh=mesh)
        opt_state = optim.init(params)
        return step, (params, opt_state, batch), {"params": params, "opt_state": opt_state,
                                                  "batch": batch}
    if shape.kind == "prefill":
        return (make_prefill_step(cfg, device=device, mesh=mesh), (params, batch),
                {"params": params, "batch": batch})
    caches = registry.init_cache(cfg, shape.global_batch, shape.seq_len, device=device,
                                 mesh=mesh)
    return (make_serve_step(cfg, device=device, mesh=mesh),
            (params, batch["token"], caches, shape.seq_len - 1),
            {"params": params, "cache": caches, "batch": batch})


def run_one(arch: str, shape_name: str, outdir: str = os.path.join("build", "dryrun"),
            mesh: str = "1x1", zero1: bool = False, variant: str = "baseline", device=None,
            smoke: bool = False):
    """Trace and cost one (arch, shape) pair on `device` (``cuda`` unless
    named; raises without a GPU), write its JSON record under `outdir`
    (None writes nothing) and return it. `smoke` takes the arch's smoke
    config (`configs.get_smoke`) in place of the published one."""
    dev = _device(device)
    mesh_spec = parse_mesh(mesh)
    shape = INPUT_SHAPES[shape_name]
    cfg = shape_adapted_config((get_smoke if smoke else get_config)(arch), shape).replace(
        **VARIANTS[variant])
    rank = mesh_spec.as_rank() if mesh_spec.size > 1 else None
    t0 = time.perf_counter()
    with FakeTensorMode(allow_fallback_kernels=False):
        step, args, parts = build_step(cfg, shape, dev, mesh=rank)
        cost = hlo_cost.analyze(step, *args)
        # the whole state's shapes, which the described mesh's specs lay out
        whole = parts if rank is None else build_step(cfg, shape, dev)[2]
    trace_s = time.perf_counter() - t0

    # specs over the described mesh, from the whole parts' shapes
    pspecs = sharding.layout_specs(whole["params"], mesh_spec)
    specs = {"params": pspecs, "batch": sharding.batch_specs_tree(whole["batch"], mesh_spec)}
    if "opt_state" in whole:
        dp = sharding.dp_axes(mesh_spec)
        ospecs = optim.state_specs(pspecs, zero1=zero1, dp_axes=dp, param_shapes=whole["params"],
                                   dp_size=sharding.axis_size(dp or None, mesh_spec))
        specs["opt_state"] = [ospecs.step, ospecs.mu, ospecs.nu]
        whole = dict(whole, opt_state=list(whole["opt_state"]))
        parts = dict(parts, opt_state=list(parts["opt_state"]))
    if "cache" in whole:
        specs["cache"] = sharding.cache_layout(whole["cache"], mesh_spec,
                                               batch_sharded=shape.global_batch > 1)
    if dev.type == "cuda":
        device_name = torch.cuda.get_device_name(dev)
        card_bytes = torch.cuda.get_device_properties(dev).total_memory
    else:
        device_name, card_bytes = "cpu", int(H100_MEMORY_BYTES)
    memory = {f"{k}_bytes": _nbytes(parts.get(k, ())) for k in ("params", "opt_state", "cache",
                                                                "batch")}
    memory["peak_bytes"] = cost["peak_bytes"]
    result = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": mesh_spec.name,
        "mesh_axes": list(mesh_spec.axis_names),
        "chips": mesh_spec.size,
        "ok": True,
        "traced_as": "one card" if rank is None else "rank 0",
        "trace_s": round(trace_s, 3),
        "device": device_name,
        "flops": cost["flops"],
        "bytes_accessed": cost["bytes"],
        "collective_bytes": cost["collective_bytes"],
        "collective_counts": cost["collective_counts"],
        "collective_passes": cost["collective_passes"],
        "roofline_s": {"compute": cost["flops"] / H100_BF16_FLOP_PER_S,
                       "memory": cost["bytes"] / H100_HBM_BYTES_PER_S},
        "memory": memory,
        "peak_tracker": "repro_torch.launch.hlo_cost.LiveBytes",
        "per_card_bytes": {k: _per_card(whole[k], specs[k], mesh_spec) for k in specs},
        "card_bytes": card_bytes,
        "fits_one_card": cost["peak_bytes"] <= card_bytes,
        "model_params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "sliding_window": cfg.sliding_window,
        "zero1": zero1,
        "variant": variant,
        "smoke": smoke,
    }
    if outdir is not None:
        os.makedirs(outdir, exist_ok=True)
        sfx = ("" if variant == "baseline" and not zero1 else (
            f"__{variant}" + ("_zero1" if zero1 else ""))) + ("__smoke" if smoke else "")
        with open(os.path.join(outdir, f"{arch}__{shape_name}__{mesh_spec.name}{sfx}.json"),
                  "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="1x1", help="DxM or PxDxM, described (default 1x1)")
    ap.add_argument("--zero1", action="store_true", help="ZeRO-1 optimizer sharding")
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="each arch's smoke config")
    ap.add_argument("--outdir", default=os.path.join("build", "dryrun"))
    args = ap.parse_args(argv)

    _device(args.device)  # raises before any work when there is no GPU
    pairs = ([(a, s) for a in ASSIGNED for s in INPUT_SHAPES] if args.all
             else [(args.arch, args.shape)])
    failures = []
    for arch, shape in pairs:
        try:
            r = run_one(arch, shape, args.outdir, mesh=args.mesh, zero1=args.zero1,
                        variant=args.variant, device=args.device, smoke=args.smoke)
            print(f"OK   {arch:24s} {shape:12s} {r['mesh']:8s} flops={r['flops']:.3e} "
                  f"bytes={r['bytes_accessed']:.3e} peak={r['memory']['peak_bytes']:.3e} "
                  f"fits={r['fits_one_card']} ({r['trace_s']}s)")
        except Exception as e:  # noqa: BLE001 -- the CLI reports every pair, then fails
            failures.append((arch, shape, str(e)))
            print(f"FAIL {arch:24s} {shape:12s}: {e}")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures")


if __name__ == "__main__":
    main()
