"""Samples (images or sequences) classified by `infer` over the whole
window, over the window's seconds (host clock, draws included)."""


def read(record):
    return record["samples"] / record["window_s"]
