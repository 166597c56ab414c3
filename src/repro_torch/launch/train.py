"""Training driver (port of `repro.launch.train`).

Trains any zoo architecture with the BranchyNet-style multi-exit loss on
the synthetic token stream, on one device: ``cuda`` unless ``--device``
names another. ``--smoke`` trains the reduced variant of the same family
(and turns activation checkpointing off, as the reference does). The
update overwrites the parameters and moments in place (`optim.update`),
since the loop keeps only the newest.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --smoke \
      --steps 50 --batch 8 --seq 128 --ckpt build/ck.msgpack --device cpu

Under ``python -m torch.distributed.run --nproc-per-node W`` it trains
data-parallel on a (data=W, model=1) mesh of ranks
(`launch.mesh.join_ranks`), as the reference trains on
``make_debug_mesh(jax.device_count(), 1)``: every rank draws the same
seeded init (checked equal once), reads the same stream and takes its
rows of each global ``--batch`` (`data.pipeline`), and the gradients are
reduced over the ranks (`training.loop`). Rank 0 alone prints the log
lines and writes ``--ckpt``; every rank returns the same params. A world
of one is the one-device run.

  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --arch mamba2-130m --smoke --device cpu

With ``--model M`` the W ranks form a (data = W / M, model = M) mesh
(`join_ranks(model=)`), the counterpart at one machine's size of the
reference's (data, model) production mesh: each rank draws the seeded
init and keeps its slices (`init_params(mesh=)`), the data ranks that
share a model coordinate are checked equal, and the step is
tensor-parallel over the model axis (`training.loop`; every LM
family, whisper too). ``--ckpt`` gathers the slices and rank 0 writes one
device's file (`training.checkpoint`).

  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --arch qwen3-8b --smoke --model 2 --device cpu

`--production-mesh` (the reference's TPU pod mesh) raises
NotImplementedError: one machine has no 256- or 512-chip mesh; ``--model``
runs the same (data, model) layout on this machine's ranks, and
`launch.dryrun --mesh 16x16` (or ``2x16x16``) gives the bytes each card of
such a mesh would hold.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.utils._pytree as pytree

from repro_torch import sharding
from repro_torch._device import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.data.pipeline import TokenIterator, prefetch
from repro_torch.data.synthetic import lm_sequences
from repro_torch.launch.mesh import gather_blocks, join_ranks
from repro_torch.models import registry, transformer
from repro_torch.training import checkpoint, optim
from repro_torch.training.loop import make_train_step, whole_specs


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_same_params(params, mesh):
    """Raise unless the ranks along `mesh`'s data axis (those that share
    this rank's model coordinate) hold the same params: each leaf's
    float64 sum and sum of squares, compared over them."""
    sums = torch.stack([torch.stack([x.double().sum(), x.double().square().sum()])
                        for x in pytree.tree_leaves(params)])
    every = gather_blocks(sums, mesh.coordinate("data"), mesh.axis_size("data"),
                          mesh.group("data"))
    if not bool((every == every[0]).all()):
        raise RuntimeError("the ranks' seeded params differ")


def main(argv=None):
    """Run the driver on `argv` (the command line when None). Returns the
    trained params, each step's seconds (host clock to a device sync) and
    each step's metrics (floats; the global batch's under a mesh)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--model", type=int, default=1,
                    help="model-axis ranks under torch.distributed.run (default 1)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh: one card has no 256- or 512-chip mesh; run the same "
            "(data, model) layout on this machine's ranks with `--model M` under "
            "torch.distributed.run, or `python -m repro_torch.launch.dryrun --mesh 16x16` (or "
            "2x16x16) for the bytes each card of such a mesh would hold")
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # under torch.distributed.run
        mesh, backend = join_ranks(args.device, model=args.model)
        device = mesh.device
    elif args.model != 1:
        raise ValueError(f"--model {args.model} needs that many ranks: run under "
                         "`python -m torch.distributed.run --nproc-per-node W`")
    else:
        device = resolve_device(args.device)
    lead = mesh is None or not any(mesh.coordinate(a) for a in mesh.axis_names)
    say = print if lead else (lambda *a, **k: None)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    say(f"arch={cfg.name} params={cfg.param_count():,} "
        f"active={cfg.active_param_count():,}")
    if mesh is not None:
        say(f"mesh (data={mesh.axis_size('data')}, model={mesh.axis_size('model')}) over "
            f"{backend}, rank 0 on {device}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = registry.init_params(gen, cfg, device=device, mesh=mesh)
    if mesh is not None:
        check_same_params(params, mesh)
    say(f"instantiated params: {transformer.num_params(params):,}")

    opt_cfg = optim.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=min(20, args.steps // 5 + 1))
    opt_state = optim.init(params)
    step_fn = make_train_step(cfg, opt_cfg, remat=not args.smoke, device=device, inplace=True,
                              mesh=mesh)

    stream = lm_sequences(
        max(600_000, args.batch * (args.seq + 1) * 4), cfg.vocab_size, seed=args.seed
    )
    # each batch arrives on the device as this rank's rows (all of them
    # without a mesh)
    batches = prefetch(iter(TokenIterator(stream, args.batch, args.seq, seed=args.seed)),
                       device=device, mesh=mesh)

    step_s, step_metrics = [], []
    t0 = time.time()
    for step in range(args.steps):
        t1 = time.perf_counter()
        batch = next(batches)
        if cfg.is_encoder_decoder:
            batch["encoder_frames"] = torch.zeros(
                (len(batch["tokens"]), cfg.encoder_seq, cfg.d_model),
                dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
                device=device,
            )
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        _sync(device)
        step_s.append(time.perf_counter() - t1)
        m = {k: float(v) for k, v in metrics.items()}
        step_metrics.append(m)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(
                f"step {step:5d} loss={m['loss']:.4f} final={m['loss_final']:.4f} "
                + " ".join(
                    f"{k}={v:.4f}" for k, v in m.items() if k.startswith("loss_exit")
                )
                + f" gnorm={m['grad_norm']:.2f} ({time.time()-t0:.1f}s)"
            )
    if args.ckpt:
        tree = {"params": params, "step": torch.tensor(args.steps, dtype=torch.int32)}
        by_path = whole_specs(cfg, mesh)
        if by_path is not None:  # every rank gathers its slices; rank 0 writes
            checkpoint.save(args.ckpt, tree, mesh,
                            {"params": sharding.lay_over(params, by_path), "step": ()})
        elif lead:
            checkpoint.save(args.ckpt, tree)
        say(f"saved checkpoint to {args.ckpt}")
    return {"params": params, "step_s": step_s, "metrics": step_metrics}


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
