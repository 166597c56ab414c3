"""Training driver (port of `repro.launch.train`).

Trains any zoo architecture with the BranchyNet-style multi-exit loss on
the synthetic token stream, on one device: ``cuda`` unless ``--device``
names another. ``--smoke`` trains the reduced variant of the same family
(and turns activation checkpointing off, as the reference does). The
update overwrites the parameters and moments in place (`optim.update`),
since the loop keeps only the newest.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --smoke \
      --steps 50 --batch 8 --seq 128 --ckpt build/ck.msgpack --device cpu

`--production-mesh` (the reference's TPU pod mesh) raises
NotImplementedError: one card has no 256- or 512-chip mesh.
`launch.dryrun --mesh 16x16` (or ``2x16x16``) gives the bytes each card of
such a mesh would hold.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.data.pipeline import TokenIterator
from repro_torch.data.synthetic import lm_sequences
from repro_torch.models import registry, transformer
from repro_torch.training import checkpoint, optim
from repro_torch.training.loop import make_train_step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Run the driver on `argv` (the command line when None). Returns the
    trained params and each step's seconds (host clock to a device sync)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh: one card has no 256- or 512-chip mesh; run "
            "`python -m repro_torch.launch.dryrun --mesh 16x16` (or 2x16x16) for the bytes "
            "each card of such a mesh would hold")
    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch={cfg.name} params={cfg.param_count():,} "
          f"active={cfg.active_param_count():,}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = registry.init_params(gen, cfg, device=device)
    print(f"instantiated params: {transformer.num_params(params):,}")

    opt_cfg = optim.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=min(20, args.steps // 5 + 1))
    opt_state = optim.init(params)
    step_fn = make_train_step(cfg, opt_cfg, remat=not args.smoke, device=device, inplace=True)

    stream = lm_sequences(
        max(600_000, args.batch * (args.seq + 1) * 4), cfg.vocab_size, seed=args.seed
    )
    it = iter(TokenIterator(stream, args.batch, args.seq, seed=args.seed))

    step_s = []
    t0 = time.time()
    for step in range(args.steps):
        t1 = time.perf_counter()
        batch = {k: torch.as_tensor(v, device=device) for k, v in next(it).items()}
        if cfg.is_encoder_decoder:
            batch["encoder_frames"] = torch.zeros(
                (args.batch, cfg.encoder_seq, cfg.d_model),
                dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
                device=device,
            )
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        _sync(device)
        step_s.append(time.perf_counter() - t1)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(
                f"step {step:5d} loss={m['loss']:.4f} final={m['loss_final']:.4f} "
                + " ".join(
                    f"{k}={v:.4f}" for k, v in m.items() if k.startswith("loss_exit")
                )
                + f" gnorm={m['grad_norm']:.2f} ({time.time()-t0:.1f}s)"
            )
    if args.ckpt:
        checkpoint.save(args.ckpt, {"params": params,
                                    "step": torch.tensor(args.steps, dtype=torch.int32)})
        print(f"saved checkpoint to {args.ckpt}")
    return {"params": params, "step_s": step_s}


if __name__ == "__main__":
    main()
