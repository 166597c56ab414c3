#!/usr/bin/env python3
"""Phases 15, 16, 17 and 18 of `chip_smoke.py` (tensor-parallel serving,
tensor-parallel training, the mamba and hybrid families, and the
encoder-decoder, on a model axis) alone, on the cards of this machine.

    python3 tools/tp_phase.py                # from the repo root: phases 15 and 16
    python3 tools/tp_phase.py --train        # phase 16 only
    python3 tools/tp_phase.py --ssm          # phase 17 only
    python3 tools/tp_phase.py --enc-dec      # phase 18 only
    python3 tools/tp_phase.py --train --ssm  # phases 16 and 17

It builds the kernels and runs the phases (`tp_phase`, `tp_train_phase`,
`tp_ssm_phase`, `tp_enc_dec_phase`): the same runs on one rank in this
process, then over W ranks of ``python -m torch.distributed.run`` as a
(data 1, model W) mesh, each held to the one-rank run. W is the card count where it is 2 or more
(NCCL, a card a rank), else 2 ranks sharing the one card (gloo). With
four cards or more phase 15 also serves Qwen2-72B uncut (80 layers, about
37.6 GB of bf16 parameters a card at W = 4), phase 16 trains Qwen3-8B
uncut (36 layers: its bf16 parameters, gradients and float32 AdamW
moments take about 113 GB on one card, 28 GB a card at W = 4) for 3 steps
at 8 x 512, then calibrates it and serves it at codec levels 0, 1 and 2,
and phase 17 serves jamba-v0.1-52b uncut (32 layers, about 104 GB of bf16
parameters, 26 GB a card at W = 4) at 8 x 512, 32 tokens and codec
levels 0, 1 and 2; none of the three fits one card. Phase 18 runs
whisper-base uncut at any W (it fits one card). Exits non-zero if a rank
or a comparison fails.
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

    args, uncut = sys.argv[1:], n_cards >= 4
    phases = [("tp", cs.tp_phase, cs.tp_spec(uncut=uncut)),
              ("tp_train", cs.tp_train_phase, cs.tp_train_spec(uncut=uncut)),
              ("tp_ssm", cs.tp_ssm_phase, cs.tp_ssm_spec(uncut=uncut)),
              ("tp_enc_dec", cs.tp_enc_dec_phase, cs.tp_enc_dec_spec())]
    chosen = {name for flag, name in (("--train", "tp_train"), ("--ssm", "tp_ssm"),
                                      ("--enc-dec", "tp_enc_dec")) if flag in args} or {
        "tp", "tp_train"}
    phases = [ph for ph in phases if ph[0] in chosen]
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
