#!/usr/bin/env python3
"""Phase 8 of `chip_smoke.py` (the serving runtime, with EngineCore's host
us per request) on several checkouts in turns, on one card, to compare
them in one call.

    python3 tools/phase8_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout holding `chip_smoke.py` and
`src/`. Each runs in a process of its own, in the order given: it
trains B-AlexNet as phase 4 does (6 epochs at batch 256 on
cifar_like(seed=0)), makes phase 8's plans and runs that checkout's
`runtime_phase` on the card. Every line the runs print is prefixed with
the run's number and root; the EngineCore lines carry the host us per
request. Exits non-zero if any run fails.
"""
import os
import subprocess
import sys

CHILD = r"""
import sys, time
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import torch
import chip_smoke as cs
from repro_torch.core.policy import make_plan
from repro_torch.data.synthetic import cifar_like
from repro_torch.serving.scenarios import fit_drift_plans, synthetic_distorted_cascade

assert torch.cuda.is_available(), "phase 8 runs on the card"
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
cuda = torch.device("cuda")


def say(msg, timed=False):
    print(msg, flush=True)


data = cifar_like(seed=0)
params, z, _ = cs.train_phase(cuda, data, 6, 256, say=lambda *a, **k: None)
(v1, v2, _), val_y = z["val"], z["val_y"]
plan = make_plan([v1, v2], val_y, p_tar=0.8)
val_d, test_d = synthetic_distorted_cascade()
drift = (val_d, test_d, fit_drift_plans(val_d, device=cuda))
t0 = time.perf_counter()
cs.runtime_phase(cuda, params, data, plan, drift, say=say)
print(f"runtime phase {time.perf_counter() - t0:.2f} s", flush=True)
"""


def main(roots) -> int:
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    failed = 0
    for i, root in enumerate(roots):
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", CHILD, root], capture_output=True,
                              text=True, timeout=900)
        for line in (proc.stdout + proc.stderr).splitlines():
            print(f"[{i} {root}] {line}", flush=True)
        failed += proc.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
