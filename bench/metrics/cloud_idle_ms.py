"""The card's idle time inside ``engine.cloud`` (the cloud partition on
the refused rows and its sync), over its calls (`benchkit.program_trace`);
None in a window with no cloud call."""
from benchkit.program_trace import per_call


def read(record):
    return per_call(record, "engine.cloud", "idle_s", 1e3)
