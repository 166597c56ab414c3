"""Metrics registry: counters / gauges / histograms with label sets.

Port of `repro.obs.metrics`; the Prometheus text is the reference's,
byte for byte, for the same registry contents.

A deliberately small, dependency-free registry with two export formats:
`to_json()` (round-trips through `MetricsRegistry.from_json`, which is
what `repro_torch.obs.check` consumes) and `to_prometheus()` (the text
exposition format, cumulative `_bucket{le=...}` / `_sum` / `_count`
histogram series) so the artifacts a run writes can be scraped by
standard tooling.

Label sets are plain keyword arguments::

    reg = MetricsRegistry()
    reg.inc("fleet_requests_total", 128, cell=3)
    reg.set_gauge("fleet_requests_expected", 102_400)
    reg.observe("serving_latency_ms", 12.5)

Counters only go up; `observe` feeds a histogram (declare custom bucket
bounds once with `declare_histogram`, otherwise `DEFAULT_BUCKETS_MS`
apply). Everything is synchronous, in-process, and cheap enough to sit
on the simulators' per-window path.
"""
from __future__ import annotations

import bisect
import json
from typing import Dict, List, Optional, Sequence, Tuple

#: Default histogram bounds, sized for request latencies in milliseconds.
DEFAULT_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _key(labels: Dict[str, object]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else f"{f:.10g}"


def _escape_label(v: str) -> str:
    """Prometheus label-value escaping: backslash, double quote, newline."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """Prometheus HELP-text escaping: backslash and newline only."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(key: _LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in key) + "}"


#: Seed help texts for the metric families the serving stacks export.
#: `MetricsRegistry.describe` registers/overrides entries per instance.
_HELP_SEED = {
    "serving_requests_total": "Requests completed by the event-driven "
    "serving runtime.",
    "serving_offloaded_total": "Requests the gate sent to the cloud.",
    "serving_deadline_miss_total": "Requests finishing past their deadline.",
    "serving_latency_ms": "End-to-end request latency (ms).",
    "fleet_requests_total": "Requests completed per origin cell.",
    "fleet_offloaded_total": "Fleet requests offloaded to the shared cloud.",
    "fleet_latency_ms": "Fleet end-to-end request latency (ms).",
    "serving_uplink_bytes_total": "Post-codec payload bytes the serving "
    "runtime shipped over the uplink.",
    "fleet_uplink_bytes_total": "Post-codec payload bytes shipped toward "
    "the cloud per origin cell (uplink and backhaul).",
    "trace_records_total": "Trace records emitted per source.",
    "calibration_ece": "Windowed expected calibration error from the "
    "reliability sketch.",
    "calibration_coverage": "Fraction of on-device exits that were correct "
    "(gate precision vs p_tar).",
    "calibration_brier": "Brier score of gate confidence vs edge "
    "correctness.",
    "calibration_gated_total": "Gate decisions accumulated into the "
    "reliability sketch.",
    "calibration_ungated_total": "Requests served without a gate decision "
    "(backhaul routing).",
    "calibration_confidence": "Reliability-bin histogram of gate "
    "confidences.",
}


class MetricsRegistry:
    def __init__(self):
        self._counters: Dict[str, Dict[_LabelKey, float]] = {}
        self._gauges: Dict[str, Dict[_LabelKey, float]] = {}
        self._hists: Dict[str, Dict[_LabelKey, Dict]] = {}
        self._buckets: Dict[str, Tuple[float, ...]] = {}
        self._help: Dict[str, str] = dict(_HELP_SEED)

    def describe(self, name: str, text: str) -> None:
        """Attach/override the `# HELP` text emitted for `name`."""
        self._help[name] = str(text)

    def help_text(self, name: str, kind: str) -> str:
        return self._help.get(name, f"{name} ({kind}).")

    # ------------------------------------------------------------- write
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {name!r} cannot decrease")
        series = self._counters.setdefault(name, {})
        k = _key(labels)
        series[k] = series.get(k, 0.0) + float(value)

    def set_gauge(self, name: str, value: float, **labels) -> None:
        self._gauges.setdefault(name, {})[_key(labels)] = float(value)

    def declare_histogram(self, name: str,
                          buckets: Sequence[float] = DEFAULT_BUCKETS_MS) -> None:
        bounds = tuple(sorted(float(b) for b in buckets))
        if name in self._buckets and self._buckets[name] != bounds:
            raise ValueError(f"histogram {name!r} re-declared with new buckets")
        self._buckets[name] = bounds

    def observe(self, name: str, value: float, **labels) -> None:
        bounds = self._buckets.setdefault(name, tuple(DEFAULT_BUCKETS_MS))
        series = self._hists.setdefault(name, {})
        k = _key(labels)
        h = series.get(k)
        if h is None:
            h = series[k] = {"counts": [0] * (len(bounds) + 1),
                             "sum": 0.0, "count": 0}
        # counts[i] = observations with value <= bounds[i]; last slot = +Inf
        h["counts"][bisect.bisect_left(bounds, float(value))] += 1
        h["sum"] += float(value)
        h["count"] += 1

    def observe_counts(self, name: str, counts: Sequence[float],
                       total_sum: float, **labels) -> None:
        """Bulk-accumulate a pre-binned histogram: `counts[i]` lands in
        slot i of the declared bounds (last slot = +Inf), `total_sum`
        adds to the running sum. The entry point for sketch-derived
        histograms where per-sample `observe` calls would be wasteful."""
        bounds = self._buckets.setdefault(name, tuple(DEFAULT_BUCKETS_MS))
        if len(counts) != len(bounds) + 1:
            raise ValueError(
                f"histogram {name!r}: {len(counts)} counts for "
                f"{len(bounds)} bounds (+Inf slot required)"
            )
        series = self._hists.setdefault(name, {})
        k = _key(labels)
        h = series.get(k)
        if h is None:
            h = series[k] = {"counts": [0] * (len(bounds) + 1),
                             "sum": 0.0, "count": 0}
        n = 0
        for i, c in enumerate(counts):
            c = int(c)
            if c < 0:
                raise ValueError(f"histogram {name!r}: negative bulk count")
            h["counts"][i] += c
            n += c
        h["sum"] += float(total_sum)
        h["count"] += n

    # -------------------------------------------------------------- read
    def counter_total(self, name: str, **labels) -> float:
        """Sum of a counter across label sets matching the given subset."""
        want = dict(_key(labels))
        total = 0.0
        for k, v in self._counters.get(name, {}).items():
            if all(dict(k).get(lk) == lv for lk, lv in want.items()):
                total += v
        return total

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        return self._gauges.get(name, {}).get(_key(labels))

    # ------------------------------------------------------------ export
    def to_json(self) -> Dict:
        def dump(series):
            return {
                name: [{"labels": dict(k), "value": v}
                       for k, v in sorted(vals.items())]
                for name, vals in sorted(series.items())
            }

        hists = {}
        for name, vals in sorted(self._hists.items()):
            bounds = list(self._buckets[name])
            hists[name] = [
                {"labels": dict(k), "buckets": bounds,
                 "counts": list(h["counts"]), "sum": h["sum"],
                 "count": h["count"]}
                for k, h in sorted(vals.items())
            ]
        return {"counters": dump(self._counters),
                "gauges": dump(self._gauges),
                "histograms": hists}

    @classmethod
    def from_json(cls, d: Dict) -> "MetricsRegistry":
        reg = cls()
        for name, rows in d.get("counters", {}).items():
            for r in rows:
                reg.inc(name, r["value"], **r["labels"])
        for name, rows in d.get("gauges", {}).items():
            for r in rows:
                reg.set_gauge(name, r["value"], **r["labels"])
        for name, rows in d.get("histograms", {}).items():
            for r in rows:
                reg.declare_histogram(name, r["buckets"])
                k = _key(r["labels"])
                reg._hists.setdefault(name, {})[k] = {
                    "counts": list(r["counts"]), "sum": float(r["sum"]),
                    "count": int(r["count"])}
        return reg

    def write_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=1, sort_keys=True)

    @classmethod
    def read_json(cls, path: str) -> "MetricsRegistry":
        with open(path) as fh:
            return cls.from_json(json.load(fh))

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for name, vals in sorted(self._counters.items()):
            lines.append(f"# HELP {name} {_escape_help(self.help_text(name, 'counter'))}")
            lines.append(f"# TYPE {name} counter")
            for k, v in sorted(vals.items()):
                lines.append(f"{name}{_label_str(k)} {_fmt(v)}")
        for name, vals in sorted(self._gauges.items()):
            lines.append(f"# HELP {name} {_escape_help(self.help_text(name, 'gauge'))}")
            lines.append(f"# TYPE {name} gauge")
            for k, v in sorted(vals.items()):
                lines.append(f"{name}{_label_str(k)} {_fmt(v)}")
        for name, vals in sorted(self._hists.items()):
            lines.append(f"# HELP {name} {_escape_help(self.help_text(name, 'histogram'))}")
            lines.append(f"# TYPE {name} histogram")
            bounds = self._buckets[name]
            for k, h in sorted(vals.items()):
                cum = 0
                for b, c in zip(bounds, h["counts"]):
                    cum += c
                    le = dict(k, le=_fmt(b))
                    lines.append(f"{name}_bucket{_label_str(_key(le))} {cum}")
                inf = dict(k, le="+Inf")
                lines.append(
                    f"{name}_bucket{_label_str(_key(inf))} {h['count']}")
                lines.append(f"{name}_sum{_label_str(k)} {_fmt(h['sum'])}")
                lines.append(f"{name}_count{_label_str(k)} {h['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_prometheus(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_prometheus())
