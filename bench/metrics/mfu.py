"""The model step's share of the card's peak: the frozen analytic FLOPs of
every batch of the window (edge on b rows, cloud on the m refused rows;
the configuration's ``flops.py``) over the window's seconds, over the
peak of the precision the configuration runs in (`benchkit.peaks`)."""


def read(record):
    return 100.0 * record["flops"] / record["window_s"] / record["peak_flops"]
