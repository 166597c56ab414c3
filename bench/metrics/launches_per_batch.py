"""The host's launch calls (kernels, copies, memsets: `program_trace.
LAUNCHES`) inside ``engine.infer``, its partitions included, over its
calls (`benchkit.program_trace`)."""
from benchkit.program_trace import per_call


def read(record):
    return per_call(record, "engine.infer", "launches")
