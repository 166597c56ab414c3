"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bench/`` and
the port (``src/repro_torch``). With ``--trace 0`` the line's metrics are
the cell's end-to-end metrics; with ``--trace 1`` a `torch.profiler`
trace of the window gives its per-layer metrics. The check's numbers go
to standard error as its last lines, each beside its limit, and into the
line under ``checks``. No card, fewer cards than the cell asks for, a
module of JAX or of the JAX package loaded, or a port that is not there:
a non-zero exit and no line.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BUILD = ROOT / "build" / "bench"
# every cache a build or a compiler writes stays in the checkout, at a fixed path
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import torch  # noqa: E402

from benchkit import runner  # noqa: E402
from benchkit.manifest import Manifest  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = Manifest(ROOT).cell(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result, lines = runner.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                               t0=T0)
    found = runner.forbidden_modules()
    if found:
        print(f"error: loaded {found}, which the port must not load", file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
