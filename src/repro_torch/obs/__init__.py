"""Unified observability plane: tracing, audit, metrics, invariants.

Port of `repro.obs`: pure Python and host numpy, no tensor and no
kernel. One `Observability` bundle threads through the event-driven
serving runtime, the fleet simulator and the orchestration plane::

    from repro_torch.obs import Observability, RingBufferSink, AuditLog, MetricsRegistry

    obs = Observability(trace=RingBufferSink(), audit=AuditLog(),
                        metrics=MetricsRegistry())
    tel = run_congested_markov(plan, exits, final, y, obs=obs, device="cpu")

Everything is opt-in and **zero-perturbation**: with ``obs=None`` (the
default) no instrumentation code runs and every summary reproduces
bit-exactly -- `tests/test_torch_obs.py` pins that parity. The artifacts the
sinks collect are cross-examined by `repro_torch.obs.check` (span
telescoping, request conservation, gate/offload consistency, audit
causal chains).

`span` (`obs.spans`) names the served path's phases on the card's
timeline for `torch.profiler`. It too is zero-perturbation: with no
profiler on it reads one flag and enters no span.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .audit import AuditLog
from .calibration import ReliabilitySketch
from .export import export_calibration, fleet_metrics, serving_metrics
from .metrics import DEFAULT_BUCKETS_MS, MetricsRegistry
from .spans import span
from .trace import (
    SPAN_NAMES,
    JsonlTraceSink,
    RingBufferSink,
    TraceSink,
    build_spans,
    read_jsonl,
    request_record,
)

__all__ = [
    "AuditLog",
    "DEFAULT_BUCKETS_MS",
    "JsonlTraceSink",
    "MetricsRegistry",
    "Observability",
    "ReliabilitySketch",
    "RingBufferSink",
    "SPAN_NAMES",
    "TraceSink",
    "build_spans",
    "export_calibration",
    "fleet_metrics",
    "full_observability",
    "read_jsonl",
    "request_record",
    "serving_metrics",
    "span",
]


@dataclass
class Observability:
    """Which sinks are attached. Any member may be None (disabled);
    `trace_sample_every` strides the fleet simulator's per-request trace
    emission (1 = every request; the event-driven serving runtime always
    traces every request when a sink is attached)."""

    trace: Optional[TraceSink] = None
    audit: Optional[AuditLog] = None
    metrics: Optional[MetricsRegistry] = None
    calibration: Optional[ReliabilitySketch] = None
    trace_sample_every: int = 1

    @property
    def enabled(self) -> bool:
        return (self.trace is not None or self.audit is not None
                or self.metrics is not None or self.calibration is not None)

    def close(self) -> None:
        if self.trace is not None:
            self.trace.close()


def full_observability(trace_capacity: int = 200_000,
                       trace_sample_every: int = 1) -> Observability:
    """Everything on, in memory -- the one-liner for tests and notebooks."""
    return Observability(trace=RingBufferSink(trace_capacity),
                         audit=AuditLog(), metrics=MetricsRegistry(),
                         calibration=ReliabilitySketch(),
                         trace_sample_every=trace_sample_every)
