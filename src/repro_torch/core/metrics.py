"""Reliability metrics (paper Secs. II, IV-B..IV-E).

Port of `repro.core.metrics`:
  * ECE + reliability diagram (Guo et al. 2017) -- Fig. 3(a);
  * on-device classification probability and accuracy -- Figs. 2, 3(b,c);
  * inference outage probability (the paper's new metric, Sec. IV-D).
Binning and batching run in numpy on the host, as in the reference; gate
statistics come from `core.exits.gate_statistics` (K1 on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import as_tensor, to_numpy
from repro_torch.core.exits import gate_statistics

PAPER_OUTAGE_BATCH = 512  # paper: "batches with 512 images each"


def ece(confidences, correct, n_bins: int = 15):
    """Expected Calibration Error with equal-width confidence bins."""
    confidences = to_numpy(confidences).astype(np.float64)
    correct = to_numpy(correct).astype(np.float64)
    bins = np.linspace(0.0, 1.0, n_bins + 1)
    e = 0.0
    n = len(confidences)
    for lo, hi in zip(bins[:-1], bins[1:]):
        m = (confidences > lo) & (confidences <= hi)
        if m.sum() == 0:
            continue
        e += (m.sum() / n) * abs(correct[m].mean() - confidences[m].mean())
    return float(e)


def reliability_diagram(confidences, correct, n_bins: int = 15):
    """Per-bin (mean confidence, accuracy, count) -- Fig. 3(a) data."""
    confidences = to_numpy(confidences).astype(np.float64)
    correct = to_numpy(correct).astype(np.float64)
    bins = np.linspace(0.0, 1.0, n_bins + 1)
    rows = []
    for lo, hi in zip(bins[:-1], bins[1:]):
        m = (confidences > lo) & (confidences <= hi)
        if m.sum() == 0:
            rows.append((0.5 * (lo + hi), np.nan, 0))
        else:
            rows.append((confidences[m].mean(), correct[m].mean(), int(m.sum())))
    return rows


def device_statistics(exit_logits, labels, p_tar, temperature=1.0):
    """Single-branch device-side stats for one p_tar (Figs. 2, 3a, 3b).

    Returns dict of 0-d tensors: on_device_prob, device_accuracy,
    mean_confidence (nan when nothing exits).
    """
    conf, pred, _ = gate_statistics(exit_logits, temperature)
    labels = as_tensor(labels, conf.device).to(conf.device)
    mask = conf >= p_tar
    n_dev = torch.sum(mask)
    denom = torch.clamp(n_dev, min=1).to(torch.float32)
    nan = torch.full((), float("nan"), device=conf.device)
    correct = (pred == labels) & mask
    return {
        "on_device_prob": n_dev / labels.shape[0],
        "device_accuracy": torch.where(n_dev > 0, torch.sum(correct) / denom, nan),
        "mean_confidence": torch.where(n_dev > 0, torch.sum(conf * mask) / denom, nan),
    }


def overall_accuracy(exit_logits_list, final_logits, labels, p_tar, temperatures=None):
    """Cascade accuracy over ALL samples (device + cloud) -- Fig. 3(c)."""
    from repro_torch.core.exits import cascade_gate

    out = cascade_gate(exit_logits_list, final_logits, p_tar, temperatures)
    pred = out["prediction"]
    labels = as_tensor(labels, pred.device).to(pred.device)
    return float(torch.mean((pred == labels).to(torch.float32)))


def _outage(served, pred, labels, p_tar, batch_size, idx=None):
    """Share of whole batches whose on-device accuracy falls below p_tar;
    a batch where nothing exits counts as no outage."""
    n = len(labels)
    idx = np.arange(n) if idx is None else idx
    outages, batches = 0, 0
    for s in range(0, n - batch_size + 1, batch_size):
        b = idx[s : s + batch_size]
        m = served[b]
        batches += 1
        if m.sum() == 0:
            continue
        acc = (pred[b][m] == labels[b][m]).mean()
        if acc < p_tar:
            outages += 1
    return outages / max(batches, 1)


def inference_outage_probability(
    exit_logits,
    labels,
    p_tar,
    temperature=1.0,
    batch_size: int = PAPER_OUTAGE_BATCH,
    rng: np.random.Generator | None = None,
):
    """Paper Sec. IV-D: P(batch on-device accuracy < p_tar).

    The test set is divided into batches of `batch_size`; for each batch the
    average accuracy of the on-device-classified samples is compared to
    p_tar. Batches where no sample exits count as no outage.
    """
    conf, pred, _ = gate_statistics(exit_logits, temperature)
    conf, pred, labels = to_numpy(conf), to_numpy(pred), to_numpy(labels)
    idx = rng.permutation(len(labels)) if rng is not None else None
    return _outage(conf >= p_tar, pred, labels, p_tar, batch_size, idx)


def outage_probability_cascade(
    exit_logits_list,
    labels,
    p_tar,
    temperatures=None,
    batch_size: int = PAPER_OUTAGE_BATCH,
):
    """Multi-branch outage (Fig. 7): on-device = classified by ANY branch."""
    n_exits = len(exit_logits_list)
    if temperatures is None:
        temperatures = [1.0] * n_exits
    labels = to_numpy(labels)
    n = len(labels)
    served = np.zeros(n, bool)
    pred = np.zeros(n, np.int64)
    for logits, T in zip(exit_logits_list, temperatures):
        conf, p, _ = gate_statistics(logits, T)
        conf, p = to_numpy(conf), to_numpy(p)
        take = (~served) & (conf >= p_tar)
        pred[take] = p[take]
        served |= take
    return _outage(served, pred, labels, p_tar, batch_size)
