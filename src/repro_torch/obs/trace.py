"""Per-request tracing: span timelines through pluggable sinks.

Port of `repro.obs.trace`.

A trace record is one JSON-serializable dict per completed request with a
span timeline that *tiles* the interval ``[arrival_s, complete_s]`` --
each span's end is the next span's start, so span durations telescope to
the end-to-end latency exactly (up to float round-off). That tiling is a
checkable invariant (`repro_torch.obs.check`), not a convention: both the
event-driven `ServingRuntime` and the columnar `FleetSimulator` build
their spans through `build_spans`, so the two stacks cannot drift apart
on what a latency decomposition means.

Span grammar (in timeline order)::

    queue_edge   arrival .. edge service start   (device queue wait)
    edge         edge service start .. edge done (on-device compute)
    -- offloaded requests continue --
    queue_uplink edge done .. uplink start       (microbatch + link wait)
    uplink       uplink start .. uplink done     (transfer)
    queue_cloud  uplink done .. cloud start      (cloud server wait)
    cloud        cloud start .. complete         (cloud compute)

Sinks are deliberately tiny: `emit(record)` + `close()`. The in-memory
`RingBufferSink` bounds live inspection; `JsonlTraceSink` streams one
JSON object per line for offline checking (`python -m repro_torch.obs.check`).
"""
from __future__ import annotations

import json
from collections import deque
from typing import Dict, Iterable, List, Optional

SPAN_NAMES = ("queue_edge", "edge", "queue_uplink", "uplink",
              "queue_cloud", "cloud")


class TraceSink:
    """Minimal sink interface. Subclasses override `emit`."""

    def emit(self, record: Dict) -> None:
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - default no-op
        pass


class RingBufferSink(TraceSink):
    """Keep the most recent `capacity` records in memory.

    `emitted` counts every record ever seen (the conservation checks use
    it even after old records fell off the ring)."""

    def __init__(self, capacity: int = 100_000):
        self.capacity = int(capacity)
        self._buf: deque = deque(maxlen=self.capacity)
        self.emitted = 0

    def emit(self, record: Dict) -> None:
        self._buf.append(record)
        self.emitted += 1

    @property
    def records(self) -> List[Dict]:
        return list(self._buf)

    def __len__(self) -> int:
        return len(self._buf)


class JsonlTraceSink(TraceSink):
    """Stream records to a file, one JSON object per line."""

    def __init__(self, path: str):
        self.path = str(path)
        self._fh = open(self.path, "w")
        self.emitted = 0

    def emit(self, record: Dict) -> None:
        self._fh.write(json.dumps(record))
        self._fh.write("\n")
        self.emitted += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_jsonl(path: str) -> List[Dict]:
    """Load a JSONL trace/audit file back into a list of dicts."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def build_spans(
    arrival_s: float,
    edge_start_s: float,
    edge_done_s: float,
    uplink_start_s: Optional[float] = None,
    uplink_done_s: Optional[float] = None,
    cloud_start_s: Optional[float] = None,
    complete_s: Optional[float] = None,
) -> List[Dict]:
    """The one span grammar both simulators emit through.

    On-device requests pass only the first three timestamps; offloaded
    requests pass all seven. Zero-duration spans are kept (a backhauled
    fleet request has a zero-length edge span) so the timeline always
    tiles ``[arrival, complete]`` without gaps.
    """
    spans = [
        {"name": "queue_edge", "start_s": float(arrival_s),
         "end_s": float(edge_start_s)},
        {"name": "edge", "start_s": float(edge_start_s),
         "end_s": float(edge_done_s)},
    ]
    if uplink_start_s is not None:
        spans.extend([
            {"name": "queue_uplink", "start_s": float(edge_done_s),
             "end_s": float(uplink_start_s)},
            {"name": "uplink", "start_s": float(uplink_start_s),
             "end_s": float(uplink_done_s)},
            {"name": "queue_cloud", "start_s": float(uplink_done_s),
             "end_s": float(cloud_start_s)},
            {"name": "cloud", "start_s": float(cloud_start_s),
             "end_s": float(complete_s)},
        ])
    return spans


def request_record(
    source: str,
    req_id: int,
    arrival_s: float,
    complete_s: float,
    on_device: bool,
    spans: List[Dict],
    gate: Optional[Dict] = None,
    cell: Optional[int] = None,
    device: Optional[int] = None,
    payload_nbytes: Optional[int] = None,
) -> Dict:
    """One completed request. `gate` carries the verdict evidence
    (branch, p_tar threshold, confidence, criterion, context, expert);
    it is None when no gate ran (e.g. cloud-backhauled fleet requests).
    `payload_nbytes` is the wire size of the shipped activation (post
    codec) for offloaded requests; None for on-device completions."""
    return {
        "kind": "request",
        "source": source,
        "req_id": int(req_id),
        "cell": None if cell is None else int(cell),
        "device": None if device is None else int(device),
        "arrival_s": float(arrival_s),
        "complete_s": float(complete_s),
        "latency_s": float(complete_s) - float(arrival_s),
        "on_device": bool(on_device),
        "payload_nbytes": None if payload_nbytes is None else int(payload_nbytes),
        "gate": gate,
        "spans": spans,
    }
