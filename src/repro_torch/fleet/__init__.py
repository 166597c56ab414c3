"""Fleet-scale vectorized serving simulation (port of `repro.fleet`).

The event-driven `repro_torch.serving.ServingRuntime` is exact but
per-request: one Python callback per arrival, gate, transfer, and
completion. That is the right tool for one cell, and the wrong one for
"millions of users": simulating 100k requests takes minutes of heap
churn. This package trades per-event exactness for *windowed, vectorized*
semantics -- whole arrival windows move through each tier as numpy
blocks -- and simulates hundreds of thousands of requests across dozens
of cells in seconds, while provably collapsing onto the event runtime in
the single-cell, single-device, fixed-link limit (pinned by
`tests/test_torch_fleet.py`).

* `topology`   -- `CellConfig`/`FleetTopology`: C cells, each with its
                  own device group, shared uplink (`NetworkModel`), drift
                  schedule, and workload, all feeding one cloud tier;
* `gate`       -- a shim over `repro_torch.core.gatepath.GateTable` (the
                  name `FleetGateTable` remains): per-(context, expert,
                  branch) confidence/prediction blocks precomputed and
                  window-gated through the selectable `GateBackend`
                  (host numpy, or gathers from card-resident tables);
* `simulator`  -- `FleetSimulator`: the time-stepped vectorized pipeline
                  (edge FIFO recurrences, per-cell uplink queue, shared
                  multi-server cloud), all O(window) numpy;
* `controller` -- `FleetController`: fleet policy over the shared
                  `repro_torch.core.control.ControllerCore` (per-cell
                  context-aware re-scoring from windowed telemetry,
                  distress-gated p_tar concession) plus the fleet-only
                  shared-cloud utilization cap across cells;
* `telemetry`  -- `FleetTelemetry`: per-cell and fleet-wide p50/p95/p99,
                  miss rate, offload rate, and miscalibration gap, sharing
                  the metric definitions of `repro_torch.serving.telemetry`;
* `scenarios`  -- the reference multi-cell drift scenario;
* `maxplus`    -- the max-plus FIFO solvers on float64 tensors (the
                  compiled fleet's queue algebra) and their oracles;
* `compiled`   -- `CompiledFleetSimulator`: the whole window pipeline as
                  one float64 torch program over the cells on one device,
                  selected by the ``"compiled"`` gate backend
                  (`CompiledGateBackend`).

The host pipeline is numpy, as in the reference. The card does the gate
(K1 blocks, device gathers) and codec (K3/K4) work through the gate
backend, and under ``"compiled"`` the whole pipeline; entry points follow
the port's device rule (``"torch"`` unless the caller names ``"numpy"``
or a CPU device).
"""
from repro_torch.core.gatepath import GateBackend, GateTable, get_gate_backend
from repro_torch.fleet.compiled import CompiledFleetSimulator, CompiledGateBackend
from repro_torch.fleet.controller import FleetController, FleetControllerConfig
from repro_torch.fleet.simulator import FleetConfig, FleetSimulator
from repro_torch.fleet.telemetry import FleetTelemetry
from repro_torch.fleet.topology import (
    CellConfig,
    DiurnalEnvelope,
    FleetTopology,
    poisson_cell_workload,
)

#: Historical alias (the batched gate grew into `GateTable`); kept here
#: warning-free, while `repro_torch.fleet.gate` deprecation-warns.
FleetGateTable = GateTable

__all__ = [
    "CellConfig",
    "DiurnalEnvelope",
    "FleetTopology",
    "poisson_cell_workload",
    "GateBackend",
    "GateTable",
    "get_gate_backend",
    "FleetGateTable",
    "FleetConfig",
    "FleetSimulator",
    "CompiledFleetSimulator",
    "CompiledGateBackend",
    "FleetController",
    "FleetControllerConfig",
    "FleetTelemetry",
]
