"""The card's idle time inside ``engine.edge`` (the edge partition and its
sync), over its calls (`benchkit.program_trace`)."""
from benchkit.program_trace import per_call


def read(record):
    return per_call(record, "engine.edge", "idle_s", 1e3)
