"""One traced run of a cell, as ``bench/run.py --trace 1`` makes it, read
under the program's own spans as well.

    python3 bench/spans.py --workload <cell> --seed <n> --seconds <s>

The same Kineto events go to the harness's reduction (`benchkit.trace`)
and to `benchkit.program_trace`. Prints the run's result line with two
keys more: ``program_trace`` (calls, seconds, the card's idle seconds and
the launch calls by path of ``engine.*`` and ``lm.*`` spans) and
``program_metrics``, the readings of ``bench/metrics/``'s
``engine_idle_ms``, ``edge_idle_ms``, ``cloud_idle_ms`` and
``launches_per_batch``. Its ``info:`` lines set the idle under
``engine.infer`` beside the idle the harness puts under ``bench.infer``,
``bench.edge`` and ``bench.cloud``, and the launch calls in the window
beside the device operations there. Needs a CUDA card, as ``bench/run.py``
does.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
# the caches' directories and the import path, set as a run sets them
from run import ROOT, T0  # noqa: E402

import torch  # noqa: E402

from benchkit import program_trace, runner, trace  # noqa: E402
from benchkit.manifest import Manifest  # noqa: E402

METRICS = ("engine_idle_ms", "edge_idle_ms", "cloud_idle_ms", "launches_per_batch")
HARNESS = ("bench.infer", "bench.edge", "bench.cloud")


def traced_run(root, workload, seed, seconds, **kw):
    """`runner.run` traced, with the program's spans read from the same
    events. Returns (result, lines)."""
    held = {}
    harness_reduce = trace.reduce

    def both(events):
        events = list(events)
        held["program"] = program_trace.reduce(events)
        held["harness"] = harness_reduce(events)
        return held["harness"]

    trace.reduce = both
    try:
        result, lines = runner.run(root, workload, seed, seconds, True, **kw)
    finally:
        trace.reduce = harness_reduce
    cell = Manifest(root).cell(workload)
    pt, harness = held["program"], held["harness"]
    readings = {name: cell.metric_reader(name)({"program_trace": pt}) for name in METRICS}
    result["program_trace"] = pt
    result["program_metrics"] = {k: v for k, v in readings.items() if v is not None}

    idle_in, idle_bench = program_trace.under(pt, "engine.infer", "idle_s")[1], sum(
        harness["idle"].get(name, (0, 0.0))[1] for name in HARNESS)
    launches = sum(row["launches"] for row in pt["paths"].values())
    launches_in = program_trace.under(pt, "engine.infer", "launches")[1]
    ops = sum(n for n, _ in harness["ops"].values())
    annotated = sum(n for name, (n, _) in harness["ops"].items()
                    if name.startswith(program_trace.PROGRAM))
    lines += [program_trace.info(pt),
              f"info: idle s under engine.infer {idle_in!r}, under {', '.join(HARNESS)} "
              f"{idle_bench!r}; launch calls in the window {launches} ({launches_in:.0f} under "
              f"engine.infer, {launches - launches_in:.0f} outside the program's spans), device "
              f"operations {ops} ({annotated} named as a program span)"]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result, lines = traced_run(ROOT, args.workload, args.seed, args.seconds, t0=T0)
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
