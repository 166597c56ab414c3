"""The 95th percentile over every batch of the window of one `infer` call,
from the call to its outputs on the host (host clock; numpy's linear
interpolation between order statistics)."""
import numpy as np


def read(record):
    return 1e3 * float(np.percentile(record["latencies_s"], 95))
