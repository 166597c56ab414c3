"""Event-driven edge-cloud serving layer (port of `repro.serving`).

The paper prices offloading at one fixed 18.8 Mbps uplink and reports mean
batch latency; this package turns the reproduction into a load-testable
serving system:

* `network`   -- stochastic / time-varying uplink models behind a single
                 ``comm_time(nbytes, t)`` interface (fixed-rate, Markov
                 good/bad Wi-Fi, bandwidth-trace replay);
* `workload`  -- seeded Poisson / constant-rate / trace request generators;
* `telemetry` -- per-request bookkeeping (p50/p95/p99 latency, deadline
                 misses, queue depth, offload rate) plus the windowed
                 bandwidth/queue estimates the controller consumes;
* `runtime`   -- the discrete-event simulator: N edge devices, a shared
                 uplink, a cloud tier, and a microbatcher that coalesces
                 refused samples into cloud batches;
* `controller`-- an Edgent-style online controller over the shared
                 `repro_torch.core.control.ControllerCore`: re-selects the
                 deployed branch and effective p_tar by re-scoring the
                 OffloadPlan's fitted calibrators under measured bandwidth
                 (no re-fitting), optionally weighting the candidate table
                 by the traffic mix its own telemetry observed
                 (context-aware, the fleet controller's rule);
* `drift`     -- drifting INPUT conditions: context schedules (piecewise /
                 Markov regime drift) and `ContextualLogitsCore`, which
                 serves per-distortion-context logits and picks each
                 sample's expert plan from a `PlanBank` via the cheap
                 edge-side distortion estimator.

The event loop is host Python. The cores and the controller take
`device=` or `backend=` and run their tensors on the card unless the
caller names the CPU (`repro_torch._device`).
"""
from repro_torch.serving.controller import ControllerConfig, OnlineController
from repro_torch.serving.drift import (
    ContextSchedule,
    ContextualLogitsCore,
    MarkovContextSchedule,
    PiecewiseSchedule,
)
from repro_torch.serving.network import (
    FixedRateNetwork,
    MarkovNetwork,
    NetworkModel,
    TraceNetwork,
    network_for,
)
from repro_torch.serving.runtime import (
    EngineCore,
    LogitsCore,
    RuntimeConfig,
    ServingRuntime,
)
from repro_torch.serving.telemetry import RequestRecord, Telemetry
from repro_torch.serving.workload import (
    Request,
    constant_workload,
    poisson_workload,
    trace_workload,
)

__all__ = [
    "ControllerConfig",
    "OnlineController",
    "ContextSchedule",
    "ContextualLogitsCore",
    "MarkovContextSchedule",
    "PiecewiseSchedule",
    "NetworkModel",
    "FixedRateNetwork",
    "MarkovNetwork",
    "TraceNetwork",
    "network_for",
    "RuntimeConfig",
    "ServingRuntime",
    "LogitsCore",
    "EngineCore",
    "Telemetry",
    "RequestRecord",
    "Request",
    "poisson_workload",
    "constant_workload",
    "trace_workload",
]
