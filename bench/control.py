"""The control of a cell's comparison, or a planted fault, on the card, at
the cell's own size.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 [--fault answer_altered]

For each seed the plain reference, put in the program's place and computed
one precision below the configuration's (its ``control_precision``: TF32
for float32, fp8 for bfloat16; `benchkit.precision`), calibrates and
serves as many batches as a run checks, and the float32 reference judges
it as it judges the port. With ``--fault`` the port serves instead, with
that fault (`benchkit.faults`) under its timed path. Prints one JSON line
per run (seed, side, the compared numbers) and, last, the smallest of each
number over the runs. The benchmark's own runs never run this.
"""
import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
# the caches' directories and the import path, set as a run sets them
from run import ROOT  # noqa: E402

import torch  # noqa: E402

from benchkit import faults, judge, runner  # noqa: E402
from benchkit.manifest import Manifest  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    cell = Manifest(ROOT).cell(args.workload)
    control = None if args.fault else cell.config["control_precision"]
    if args.fault:
        faults.plant(args.fault)
    runs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = runner.run(ROOT, args.workload, seed, 0.0, False, control=control,
                               min_batches=cell.traffic["check_batches"])
        numbers = {k: v["value"] for k, v in result["checks"].items()}
        runs.append(numbers)
        print(json.dumps({"seed": seed, "side": args.fault or "control",
                          "precision": control or "port", "correct": result["correct"],
                          "failed": result["failed"], "checks": numbers}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "side": args.fault or "control",
                      "smallest": {k: min(r[k] for r in runs) for k in judge.NAMES}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
