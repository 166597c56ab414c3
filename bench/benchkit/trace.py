"""What a traced run reads from `torch.profiler`: the device's operations,
its busy time and its idle gaps, each gap named by the harness's innermost
span (``bench.*``, `record_function`) open on the host at its middle.

Read from the raw Kineto events (`prof.profiler.kineto_results.events()`),
without building the profiler's Python event tree.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
from torch.autograd import DeviceType

PREFIX = "bench."
WINDOW = PREFIX + "window"
NAME_CHARS = 160
#: device-side records that are no work of the card's: the waits CUPTI logs
NOT_WORK = ("Sync", "Wait")


def _kind(e) -> str:
    """``device`` for a kernel, copy or memset on the card, ``span`` for the
    harness's host annotation, else ``other``. (`activity_type` is missing
    from some releases' events; the device type and name then decide.)"""
    name = e.name()
    if e.device_type() == DeviceType.CUDA:
        if name.startswith(PREFIX) or any(w in name for w in NOT_WORK):
            return "other"
        kind = e.activity_type() if hasattr(e, "activity_type") else "kernel"
        return "device" if kind in ("kernel", "gpu_memcpy", "gpu_memset") else "other"
    return "span" if name.startswith(PREFIX) else "other"


def _union(intervals: np.ndarray) -> np.ndarray:
    """Sorted, merged [start, end) rows of an (n, 2) array."""
    if len(intervals) == 0:
        return intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.append(np.flatnonzero(new)[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], axis=1)


def _innermost(spans: List[Tuple[int, int, str]], t: int) -> str:
    """The name of the shortest span that holds time t, among the last few
    opened before it (spans sorted by start: the harness's spans nest and
    follow each other), else the window's."""
    lo, hi = 0, len(spans)
    while lo < hi:
        mid = (lo + hi) // 2
        if spans[mid][0] <= t:
            lo = mid + 1
        else:
            hi = mid
    held = [spans[i] for i in range(lo - 1, max(lo - 8, -1), -1) if spans[i][0] <= t < spans[i][1]]
    return min(held, key=lambda s: s[1] - s[0])[2] if held else WINDOW


def reduce(events) -> Dict:
    """Device busy seconds, operations by name and idle gaps by span within
    the harness's ``bench.window`` span."""
    ops: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    dev, spans = [], []
    for e in events:
        kind = _kind(e)
        if kind == "device":
            dev.append((e.start_ns(), e.end_ns(), e.name()))
        elif kind == "span":
            spans.append((e.start_ns(), e.end_ns(), e.name()))
    (w0, w1), = [(s, t) for s, t, name in spans if name == WINDOW]
    kept = []
    for s, t, name in dev:
        if t <= w0 or s >= w1:
            continue
        kept.append((max(s, w0), min(t, w1)))
        op = ops[name[:NAME_CHARS]]
        op[0] += 1
        op[1] += (t - s) * 1e-9
    busy = _union(np.array(kept, dtype=np.int64).reshape(-1, 2))
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    spans.sort()
    idle: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for s, t in gaps:
        slot = idle[_innermost(spans, (int(s) + int(t)) // 2)]
        slot[0] += 1
        slot[1] += (int(t) - int(s)) * 1e-9
    return {"busy_s": busy_ns * 1e-9, "window_s": (w1 - w0) * 1e-9,
            "ops": {k: (int(v[0]), v[1]) for k, v in ops.items()},
            "idle": {k: (int(v[0]), v[1]) for k, v in idle.items()}}


def breakdown(reduced: Dict, top: int = 10) -> Dict:
    """The line's ``breakdown``: the device operations that took most time
    and the idle time by what the host was doing, at most `top` each."""
    ops = sorted(reduced["ops"].items(), key=lambda kv: -kv[1][1])[:top]
    idle = sorted(reduced["idle"].items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_ops": [[f"{name} x{n}", s] for name, (n, s) in ops],
            "idle_gaps": [[f"{name} x{n}", s] for name, (n, s) in idle]}


def kernel_time(reduced: Dict, names) -> Tuple[int, float]:
    """(launches, device seconds) of the operations whose name holds one of
    `names`."""
    n, s = 0, 0.0
    for name, (count, sec) in reduced["ops"].items():
        if any(part in name for part in names):
            n += count
            s += sec
    return n, s
