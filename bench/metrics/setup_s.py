"""Process start to the first timed batch: imports, weights, calibration,
warm-up (host clock)."""


def read(record):
    return record["setup_s"]
