"""Summary-metric export: telemetry roll-ups -> MetricsRegistry gauges.

The simulators populate *counters* live (requests, offloads, sheds,
trace records) because those feed conservation checks; the headline
aggregates (p99, gap, miss rate) are computed once at the end by the
telemetry objects, and this module maps them onto gauges so one
registry holds both views. Port of `repro.obs.export`.
"""
from __future__ import annotations

import math
from typing import Optional

from .metrics import MetricsRegistry


def _set_finite(reg: MetricsRegistry, name: str, value, **labels) -> None:
    if value is None:
        return
    v = float(value)
    if math.isnan(v) or math.isinf(v):
        return
    reg.set_gauge(name, v, **labels)


def serving_metrics(telemetry,
                    registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Gauges from a `repro_torch.serving.telemetry.Telemetry` summary."""
    reg = registry if registry is not None else MetricsRegistry()
    s = telemetry.summary()
    for k, v in s.items():
        _set_finite(reg, f"serving_{k}", v)
    return reg


def fleet_metrics(telemetry, registry: Optional[MetricsRegistry] = None,
                  per_cell: bool = True) -> MetricsRegistry:
    """Gauges from a `FleetTelemetry` (`repro_torch.fleet`): the fleet
    summary plus (optionally) the operator's per-cell table."""
    reg = registry if registry is not None else MetricsRegistry()
    for k, v in telemetry.fleet_summary().items():
        _set_finite(reg, f"fleet_{k}", v)
    if per_cell:
        for c in range(telemetry.n_cells):
            for k, v in telemetry.cell_summary(c).items():
                _set_finite(reg, f"fleet_cell_{k}", v, cell=c)
    return reg


def export_calibration(sketch,
                       registry: Optional[MetricsRegistry] = None,
                       ) -> MetricsRegistry:
    """Calibration-health gauges + histogram from a `ReliabilitySketch`.

    Stable names, one row per populated key slice:

      calibration_ece{cell,context}        windowed ECE
      calibration_coverage{cell,branch}    on-device precision vs p_tar
      calibration_brier{cell}              Brier score
      calibration_gated_total{cell}        gated requests in the sketch
      calibration_ungated_total{cell}      backhauled (no-gate) requests
      calibration_confidence_bucket{...}   the reliability bins as a
                                           declared Prometheus histogram

    The histogram declares bounds at the sketch's own bin edges
    (excluding 0), so slot i holds bin i exactly; the sketch's overflow
    slot (conf <= 0) folds into slot 0 -- consistent with the
    registry's left-open/right-closed bucket rule -- and the terminal
    +Inf bucket is structurally empty (confidence <= 1)."""
    from .calibration import bin_edges

    reg = registry if registry is not None else MetricsRegistry()
    edges = bin_edges(sketch.n_bins)
    reg.declare_histogram("calibration_confidence", edges[1:])
    for cell in sketch.cells():
        _set_finite(reg, "calibration_brier", sketch.brier(cell=cell),
                    cell=cell)
        reg.set_gauge("calibration_gated_total", sketch.gated_count(cell),
                      cell=cell)
        reg.set_gauge("calibration_ungated_total",
                      sketch.ungated_count(cell), cell=cell)
        for ctx in sketch.contexts():
            block = sketch.merged_block(cell=cell, context=ctx)
            if block[0].sum() <= 0:
                continue
            _set_finite(reg, "calibration_ece",
                        sketch.ece(cell=cell, context=ctx),
                        cell=cell, context=ctx)
        branches = sorted({b for c, _, b in sketch.keys() if c == cell})
        for br in branches:
            _set_finite(reg, "calibration_coverage",
                        sketch.coverage(cell=cell, branch=br),
                        cell=cell, branch=br)
        blk = sketch.merged_block(cell=cell)
        counts = list(blk[0, :sketch.n_bins])
        counts[0] += blk[0, sketch.n_bins]  # overflow (conf <= 0) -> slot 0
        counts.append(0)  # +Inf terminal bucket: confidence <= 1 by construction
        reg.observe_counts("calibration_confidence", counts,
                           float(blk[2].sum()), cell=cell)
    _set_finite(reg, "calibration_ece", sketch.ece())
    _set_finite(reg, "calibration_coverage", sketch.coverage())
    return reg
