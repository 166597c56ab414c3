"""The comparison that decides ``correct``, and the plain calibration the
reference side uses (float64, nothing of the port).

Compared, on the rows of the batches drawn for the check:

* ``t_rel``: the port's fitted temperature against the reference's own
  fit on the same validation inputs and labels, relative;
* ``conf_exit_rel``: each confidence served from the exit against the
  reference's max softmax(z_exit / T_ref), the largest relative gap;
* ``conf_final_rel``: each confidence served from the cloud (a refused
  row) against the reference's max softmax(z_final), the same;
* ``logit_gap``: how far below the reference's best logit the port's
  served prediction lies on that route's head, over the row's largest
  |logit|, the largest over the rows;
* ``route_flips``: rows the port routed otherwise than the reference's
  gate (conf >= p_tar with T_ref), where the reference's exit confidence
  lies farther from p_tar than the ``conf_exit_rel`` limit allows; the
  rows that near p_tar are counted apart, so that a run shows how many
  rows the route was judged on.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

NAMES = ("t_rel", "conf_exit_rel", "conf_final_rel", "logit_gap", "route_flips")


def _nll(z64, y, logt):
    return -torch.log_softmax(z64 / math.exp(logt), dim=-1).gather(1, y[:, None]).mean()


def fit_temperature(logits, labels, t_min=0.05, t_max=20.0) -> float:
    """argmin_T of the mean NLL of softmax(z / T): golden-section search over
    log T, then Newton steps on log T, in float64."""
    z = logits.to(torch.float64)
    y = labels.to(device=z.device, dtype=torch.int64)
    lo, hi = math.log(t_min), math.log(t_max)
    phi = (math.sqrt(5) - 1) / 2
    a, b = hi - phi * (hi - lo), lo + phi * (hi - lo)
    fa, fb = float(_nll(z, y, a)), float(_nll(z, y, b))
    for _ in range(60):
        if fa < fb:
            hi, b, fb = b, a, fa
            a = hi - phi * (hi - lo)
            fa = float(_nll(z, y, a))
        else:
            lo, a, fa = a, b, fb
            b = lo + phi * (hi - lo)
            fb = float(_nll(z, y, b))
    logt = (lo + hi) / 2
    zy = z.gather(1, y[:, None])[:, 0]
    for _ in range(4):
        t = math.exp(logt)
        p = torch.softmax(z / t, dim=-1)
        e = (p * z).sum(-1)
        var = (p * (z - e[:, None]).square()).sum(-1)
        g = float(((zy - e) / t).mean())
        h = float((-(zy - e) / t + var / (t * t)).mean())
        if h <= 0:
            break
        logt = min(max(logt - g / h, math.log(t_min)), math.log(t_max))
    return math.exp(logt)


def confidence(logits, temperature=1.0):
    """max softmax(z / T) per row, float64."""
    return torch.softmax(logits.to(torch.float64) / temperature, dim=-1).amax(dim=-1)


def compare(port: Dict[str, torch.Tensor], ref_exit, ref_final, t_port: float, t_ref: float,
            p_tar: float, limits: Dict[str, float]):
    """The numbers of `NAMES` for one set of checked rows, and counts of
    rows: ``judged``, those whose route is judged (the reference's exit
    confidence farther from p_tar than the ``conf_exit_rel`` margin);
    ``near``, those within a relative 1e-6 of p_tar (where K1 and a plain
    gate may decide apart); ``bad``, those that break a limit.

    port: ``prediction``, ``confidence``, ``on_device`` of the checked rows
    (tensors on the reference's device); ref_exit: the reference's exit
    logits of every checked row; ref_final: its final logits of the rows
    the port refused, in their order."""
    on = port["on_device"].to(torch.bool)
    pred = port["prediction"].to(torch.int64)
    conf = port["confidence"].to(torch.float64)
    c_exit = confidence(ref_exit, t_ref)
    judged = (c_exit - p_tar).abs() > limits["conf_exit_rel"] * p_tar
    flips = (on != (c_exit >= p_tar)) & judged
    z = ref_exit.to(torch.float64).clone()
    z[~on] = ref_final.to(torch.float64)
    c_ref = torch.where(on, c_exit, confidence(z, 1.0))
    rel = (conf - c_ref).abs() / c_ref
    exit_rel, final_rel = torch.where(on, rel, 0.0), torch.where(on, 0.0, rel)
    gap = (z.amax(dim=-1) - z.gather(1, pred[:, None])[:, 0]) / z.abs().amax(dim=-1)
    numbers = {
        "t_rel": abs(t_port - t_ref) / t_ref,
        "conf_exit_rel": float(exit_rel.max()),
        "conf_final_rel": float(final_rel.max()),
        "logit_gap": float(gap.max()),
        "route_flips": int(flips.sum()),
    }
    bad = (flips | (exit_rel > limits["conf_exit_rel"]) | (final_rel > limits["conf_final_rel"])
           | (gap > limits["logit_gap"]))
    counts = {"judged": int(judged.sum()), "near": int(((c_exit - p_tar).abs()
                                                        < 1e-6 * p_tar).sum()),
              "bad": int(bad.sum())}
    return numbers, counts


def merge(parts):
    """The worst of each number over several sets of rows."""
    out = {}
    for part in parts:
        for k, v in part.items():
            out[k] = max(out.get(k, v), v)
    return out
