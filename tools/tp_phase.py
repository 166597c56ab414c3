#!/usr/bin/env python3
"""Phases 15 and 16 of `chip_smoke.py` (tensor-parallel serving, then
tensor-parallel training, on a model axis) alone, on the cards of this
machine.

    python3 tools/tp_phase.py          # from the repo root
    python3 tools/tp_phase.py --train  # phase 16 only

It builds the kernels and runs `tp_phase`, then `tp_train_phase`: the
same runs on one rank in this process, then over W ranks of ``python -m
torch.distributed.run`` as a (data 1, model W) mesh, each held to the
one-rank run. W is the card count where it is 2 or more (NCCL, a card a
rank), else 2 ranks sharing the one card (gloo). With four cards or more
phase 15 also serves Qwen2-72B uncut (80 layers, about 37.6 GB of bf16
parameters a card at W = 4) and phase 16 trains Qwen3-8B uncut (36
layers: its bf16 parameters, gradients and float32 AdamW moments take
about 113 GB on one card, 28 GB a card at W = 4) for 3 steps at 8 x 512,
then calibrates it and serves it at codec levels 0, 1 and 2; neither
model fits one card. Exits non-zero if a rank or a comparison fails.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("tp_phase: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cuda = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()
    n_cards = torch.cuda.device_count()
    print(f"nvidia-smi: {'; '.join(smi)}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{n_cards} cards", flush=True)
    from repro_torch.kernels import _build

    _build.library()
    print(f"set-up {time.perf_counter() - t0:.2f} s", flush=True)

    def say(msg, timed=False):
        print(f"[tp] {msg}" + (f" [{smi[0]}]" if timed else ""), flush=True)

    phases = [("tp_train", cs.tp_train_phase, cs.tp_train_spec(uncut=n_cards >= 4))]
    if "--train" not in sys.argv[1:]:
        phases.insert(0, ("tp", cs.tp_phase, cs.tp_spec(uncut=n_cards >= 4)))
    for name, phase, spec in phases:
        t1 = time.perf_counter()
        counts = phase(cuda, spec, os.path.join(ROOT, "build", "chip_smoke", name), say=say)
        missing = [n for n in cs.PHASE_KERNELS[name] if counts.get(n, 0) == 0]
        assert not missing, f"kernels never launched on the {name} path: {missing}"
        print(f"phase {name} in {time.perf_counter() - t1:.2f} s; the ranks' launches {counts}; "
              f"{time.perf_counter() - t0:.2f} s in all [{smi[0]}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
