"""Edge-cloud serving layer (port of `repro.serving`).

Ported so far: `network`, the stochastic and time-varying uplink models
behind one ``comm_time(nbytes, t)`` interface, which
`offload.simulator.simulate_batches(network=...)` takes. The workload,
telemetry, runtime, controller and drift modules (and the `obs` package
the runtime pulls in) wait for the serving slice.
"""
from repro_torch.serving.network import (
    FixedRateNetwork,
    MarkovNetwork,
    NetworkModel,
    TraceNetwork,
    network_for,
)

__all__ = [
    "NetworkModel",
    "FixedRateNetwork",
    "MarkovNetwork",
    "TraceNetwork",
    "network_for",
]
