"""What a traced run reads under the program's own spans: the card's idle
time and the host's launch calls, by the stack of ``engine.*`` and
``lm.*`` spans (`repro_torch.obs.span`) open at the time.

Read from the same raw Kineto events as `benchkit.trace`, within the
harness's ``bench.window`` span, which holds every program span of a
traced run. The program's spans nest on the host thread that serves. A sweep over their boundaries with a stack of open
spans cuts the window into pieces, each under one *path*: the names of the
open spans, outermost first, joined by ``/`` (``""`` where none is open).
Each idle gap of the card is split exactly at the pieces' boundaries and
each part charged to its piece's path; each launch call of the CUDA
runtime or driver (`LAUNCHES`) is charged to the path open at its start.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence, Tuple

import numpy as np
from torch.autograd import DeviceType

from benchkit import trace

#: name prefixes of the program's spans
PROGRAM = ("engine.", "lm.")
#: host calls that put one kernel, copy or memset on the card
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"})
SEP = "/"


def _idle_before(gaps: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Idle nanoseconds before each time in `t`, given sorted disjoint
    [start, end) rows of `gaps`."""
    if len(gaps) == 0:
        return np.zeros(len(t), dtype=np.int64)
    starts, ends = gaps[:, 0], gaps[:, 1]
    cum = np.concatenate([[0], np.cumsum(ends - starts)])
    k = np.searchsorted(starts, t, side="right")
    open_part = np.where(k > 0, np.maximum(ends[np.maximum(k - 1, 0)] - t, 0), 0)
    return cum[k] - open_part


def reduce(events) -> Dict:
    """Per path: the calls and seconds of the spans that end it, and the
    card's idle seconds and the launch calls whose innermost program span
    that path is."""
    busy, spans, launches, window = [], [], [], []
    for e in events:
        name = e.name()
        if name in LAUNCHES:
            launches.append(e.start_ns())
        elif trace._kind(e) == "device":
            busy.append((e.start_ns(), e.end_ns()))
        elif e.device_type() != DeviceType.CUDA:
            if name == trace.WINDOW:
                window.append((e.start_ns(), e.end_ns()))
            elif name.startswith(PROGRAM):
                spans.append((e.start_ns(), e.end_ns(), name))
    (w0, w1), = window
    spans = [sp for sp in spans if w0 <= sp[0] and sp[1] <= w1]
    busy = trace._union(np.clip(np.array(busy, dtype=np.int64).reshape(-1, 2), w0, w1))
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]

    # the sweep: piece i is [cuts[i], cuts[i + 1]) (the last ends at w1)
    # under paths[i]
    cuts, paths = [w0], [""]
    spent: Dict[str, list] = defaultdict(lambda: [0, 0])
    stack: list = []  # (end, path) of the open spans

    def close(until):
        while stack and stack[-1][0] <= until:
            end, _ = stack.pop()
            cuts.append(end)
            paths.append(stack[-1][1] if stack else "")

    for s, t, name in sorted(spans, key=lambda sp: (sp[0], -sp[1])):
        close(s)
        path = stack[-1][1] + SEP + name if stack else name
        stack.append((t, path))
        cuts.append(s)
        paths.append(path)
        spent[path][0] += 1
        spent[path][1] += t - s
    close(w1)

    bounds = np.array(cuts + [w1], dtype=np.int64)
    at = _idle_before(gaps, bounds)
    names, index = np.unique(np.array(paths, dtype=object), return_inverse=True)
    idle = np.bincount(index, weights=(at[1:] - at[:-1]).astype(np.float64),
                       minlength=len(names))
    starts = np.array([t for t in launches if w0 <= t < w1], dtype=np.int64)
    piece = np.searchsorted(bounds[:-1], starts, side="right") - 1
    count = np.bincount(index[piece], minlength=len(names))
    return {"window_s": (w1 - w0) * 1e-9,
            "paths": {str(p): {"calls": spent.get(p, (0, 0))[0],
                               "seconds": spent.get(p, (0, 0))[1] * 1e-9,
                               "idle_s": float(idle[i]) * 1e-9, "launches": int(count[i])}
                      for i, p in enumerate(names)}}


def under(reduced: Dict, name: str, key: str, without: Sequence[str] = ()) -> Tuple[int, float]:
    """(calls of span `name`, the sum of `key` over the paths that hold
    `name` and none of `without`)."""
    calls, total = 0, 0.0
    for path, row in reduced["paths"].items():
        parts = path.split(SEP)
        if parts[-1] == name:
            calls += row["calls"]
        if name in parts and not any(w in parts for w in without):
            total += row[key]
    return calls, total


def per_call(record, name: str, key: str, scale: float = 1.0, without: Sequence[str] = ()):
    """`under` over the calls of `name`, times `scale`, from the record's
    ``program_trace``; None without it or without a call of `name`."""
    reduced = record.get("program_trace")
    if not reduced:
        return None
    calls, total = under(reduced, name, key, without)
    return scale * total / calls if calls else None


def info(reduced: Dict) -> str:
    """One line: each path's calls, then its own idle ms and launch calls a
    call; the window's outside every program span in all."""
    outside = reduced["paths"].get("", {"idle_s": 0.0, "launches": 0})
    rows = sorted(((p, r) for p, r in reduced["paths"].items() if p and r["calls"]),
                  key=lambda kv: -kv[1]["idle_s"])
    return ("info: program spans, own idle ms and launches a call: " + "; ".join(
        f"{path} x{row['calls']} {1e3 * row['idle_s'] / row['calls']:.4f} ms "
        f"{row['launches'] / row['calls']:.1f}" for path, row in rows)
        + f"; outside them {outside['idle_s']:.4f} s, {outside['launches']} launches")
