"""The share of the traced window in which no kernel, copy or memset runs
on the card (`torch.profiler`'s device events, their union against the
harness's window span)."""


def read(record):
    trace = record["trace"]
    if trace is None or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
