#!/usr/bin/env python3
"""Phase 14 of `chip_smoke.py` (several ranks) alone, after the set-up it
needs, on the cards of this machine.

    python3 tools/ranks_phase.py          # from the repo root

It fits phase 9's fleet plans on the card, runs phase 10's two compiled
fleet arms that phase 14 is held to (the 64-cell global plan at codec
level 2, 256 x 4096 requests with the expert bank) on one device, makes
cifar_like(seed=0), then runs `ranks_phase`: W = the card count where it
is 2 or more (NCCL, a card a rank), else 2 ranks sharing the one card
(gloo). About a minute and a half on one H100; run it with four cards to
drive the NCCL route. Exits non-zero if a rank or a comparison fails.
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
        print("ranks_phase: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cuda = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} cards", flush=True)
    from repro_torch.data.synthetic import cifar_like
    from repro_torch.fleet import CompiledFleetSimulator, CompiledGateBackend, FleetConfig
    from repro_torch.fleet.scenarios import fleet_gate_table, reference_fleet
    from repro_torch.kernels import _build
    from repro_torch.offload import latency
    from repro_torch.serving.scenarios import fit_drift_plans, synthetic_distorted_cascade

    _build.library()
    val, test = synthetic_distorted_cascade(directions={"gaussian_blur": "under"})
    plans = fit_drift_plans(val, device=cuda)
    comp = CompiledGateBackend(device=cuda)
    tels = {}
    for name, plan, kw in (("global_level2", plans[1].with_compression(2), dict(n_cells=64)),
                           ("scale", plans[2], dict(n_cells=256, requests_per_cell=4096))):
        scn = reference_fleet(val=val, test=test, **kw)
        tels[name] = CompiledFleetSimulator(
            fleet_gate_table(plan, scn, backend=comp), scn.topology, latency.paper_2020(),
            config=FleetConfig(window_s=0.5)).run()
    data = cifar_like(seed=0)
    print(f"set-up {time.perf_counter() - t0:.2f} s", flush=True)

    def say(msg, timed=False):
        print(f"[ranks] {msg}" + (f" [{smi}]" if timed else ""), flush=True)

    spec = cs.ranks_spec()
    t1 = time.perf_counter()
    counts = cs.ranks_phase(cuda, spec, cs.ranks_data(spec, data.train_x, data.train_y),
                            (val, test, plans, tels),
                            os.path.join(ROOT, "build", "chip_smoke", "ranks"), say=say)
    print(f"phase in {time.perf_counter() - t1:.2f} s; the ranks' launches {counts}; "
          f"{time.perf_counter() - t0:.2f} s in all [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
