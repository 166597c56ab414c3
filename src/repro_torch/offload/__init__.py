"""Edge-cloud offloading (port of `repro.offload`): latency profiles and
the two-tier serving engine."""
