"""Edge-cloud offloading (port of `repro.offload`): latency profiles, the
two-tier serving engine and the batch-level missed-deadline simulator."""
