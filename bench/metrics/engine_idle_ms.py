"""The card's idle time a batch inside the engine outside its two
partitions: under ``engine.infer`` and neither ``engine.edge`` nor
``engine.cloud`` (the gate, the selection, the codec, the merge, the
result copies), over the ``engine.infer`` calls (`benchkit.program_trace`:
the profiler's clock, each idle gap split at the spans' boundaries)."""
from benchkit.program_trace import per_call


def read(record):
    return per_call(record, "engine.infer", "idle_s", 1e3, without=("engine.edge", "engine.cloud"))
