#!/usr/bin/env python3
"""What one program span (`repro_torch.obs.span`) costs the host, entered
and left, against what it replaces.

    PYTHONPATH=src python3 tools/span_cost.py [--calls 200000]

Prints one JSON line of microseconds a span, the best of five timings of
`--calls` spans each: ``span_off`` (no profiler on: the flag's check and
the shared no-op), ``nullcontext`` (a shared `contextlib.nullcontext`
alone), ``record_function_off`` (`torch.profiler.record_function` with no
profiler on, what the spans would cost without the check) and ``span_on``
(inside a CPU `torch.profiler.profile`, a tenth as many calls), with the
host's name.
"""
import argparse
import contextlib
import json
import platform
import timeit

import torch

from repro_torch.obs import span


def _cpu() -> str:
    with open("/proc/cpuinfo") as f:
        return next((line.split(":", 1)[1].strip() for line in f if line.startswith("model name")),
                    platform.processor())


def _best(fn, calls):
    return 1e6 * min(timeit.repeat(fn, number=calls, repeat=5)) / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200_000)
    n = ap.parse_args(argv).calls
    off = contextlib.nullcontext()

    def spanned():
        with span("engine.gate"):
            pass

    def bare():
        with off:
            pass

    def recorded():
        with torch.profiler.record_function("engine.gate"):
            pass

    got = {"host": platform.node(), "processor": _cpu(),
           "span_off": _best(spanned, n), "nullcontext": _best(bare, n),
           "record_function_off": _best(recorded, n)}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got["span_on"] = _best(spanned, max(1, n // 10))
    print(json.dumps(got))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
