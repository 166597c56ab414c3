"""Batch-level offloading simulator: missed-deadline probability (Sec. IV-E)
and the end-to-end latency bookkeeping behind Figs. 5 and 6.

For each test batch (paper: 512 samples):
  * every sample pays the edge compute up to its serving branch;
  * samples whose (calibrated) confidence clears p_tar stop there;
  * the rest pay uplink transfer of the partition activation + cloud compute;
  * batch inference time = average per-sample time (the paper's "overall
    time required to infer a batch of samples", normalized per sample so
    t_tar is in per-sample units);
  * a missed deadline occurs if time > t_tar OR batch accuracy (over ALL
    samples, device + cloud) < p_tar.

Port of `repro.offload.simulator`: the bookkeeping is host numpy, as in
the reference; the gate statistics go through `core.exits.gate_statistics`,
so on the card each deployed branch is one K1 launch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from repro_torch._device import as_tensor, to_numpy
from repro_torch.core.exits import gate_statistics
from repro_torch.offload import latency as L


@dataclass
class BatchOutcome:
    time_s: float  # mean per-sample inference time
    accuracy: float  # over all samples in the batch
    on_device_frac: float


def simulate_batches(
    exit_logits_list: Sequence[np.ndarray],  # per branch, (N, C) test logits
    final_logits: np.ndarray,  # (N, C) cloud main-exit logits
    labels: np.ndarray,
    p_tar: float = None,
    temperatures: Sequence[float] = None,
    profile: L.LatencyProfile = None,
    batch_size: int = 512,
    branches: Sequence[int] = (1,),
    plan=None,
    drop_last: bool = False,
    network=None,
    batch_times_s: Sequence[float] = None,
    device=None,
) -> List[BatchOutcome]:
    """branches: which physical branches are deployed, e.g. (1,) or (1, 2).
    exit_logits_list and the legacy `temperatures` run parallel to
    `branches` (entry i describes deployed branch branches[i]).

    Calibration comes either from `plan` (an OffloadPlan whose calibrators
    are per-exit, shallowest first: physical branch k gates with
    calibrator state k-1, matching OffloadEngine) or from the legacy
    `temperatures` list with an explicit `p_tar`.

    The final partial batch IS simulated (set drop_last=True for the old
    truncating behavior). `network` (a `serving.network.NetworkModel`) prices
    each batch's uplink transfer at the rate in effect at that batch's
    timestamp in `batch_times_s` (default: all at t=0); without it the
    profile's fixed uplink is used, numerically unchanged.

    Logits that are not tensors land on `device` (``cuda`` by default) for
    the gate; tensors stay on their own device.
    """
    if profile is None:
        raise ValueError("simulate_batches needs a LatencyProfile")
    if plan is not None:
        if p_tar is None:
            p_tar = plan.p_tar
    elif temperatures is None or p_tar is None:
        raise ValueError("simulate_batches needs (p_tar, temperatures) or plan")
    n = len(labels)
    n_br = len(branches)
    conf = np.zeros((n_br, n))
    pred = np.zeros((n_br, n), np.int64)
    for i, logits in enumerate(exit_logits_list[:n_br]):
        logits = as_tensor(logits, device)
        if plan is not None:
            c, p, _ = gate_statistics(plan.calibrated_logits(logits, branches[i] - 1))
        else:
            c, p, _ = gate_statistics(logits, temperatures[i])
        conf[i], pred[i] = to_numpy(c), to_numpy(p)
    labels = to_numpy(labels)
    final_pred = np.argmax(to_numpy(final_logits), axis=-1)

    # per-sample serving branch: first branch clearing p_tar, else cloud (-1)
    serve = np.full(n, -1)
    for i in range(n_br - 1, -1, -1):
        serve[conf[i] >= p_tar] = i
    # note: loop descends so earliest branch wins

    # per-sample latency
    t = np.zeros(n)
    correct = np.zeros(n, bool)
    for i, br in enumerate(branches):
        m = serve == i
        t[m] = L.edge_time(profile, br)
        # samples at branch i already paid earlier branches' edge layers:
        for j_prev in range(i):
            t[m] += L.edge_time(profile, branches[j_prev])  # conservative
        correct[m] = pred[i][m] == labels[m]
    cloud = serve == -1
    deepest = branches[-1]
    t_edge_all = sum(L.edge_time(profile, b) for b in branches)
    # comm is added per batch below so a time-varying network can reprice it
    t[cloud] = t_edge_all + L.cloud_time(profile, deepest)
    correct[cloud] = final_pred[cloud] == labels[cloud]

    out = []
    stop = n - batch_size + 1 if drop_last else n
    n_batches = len(range(0, stop, batch_size))
    if batch_times_s is not None and len(batch_times_s) < n_batches:
        raise ValueError(
            f"batch_times_s has {len(batch_times_s)} entries but "
            f"{n_batches} batches will run (drop_last={drop_last})"
        )
    for k, s in enumerate(range(0, stop, batch_size)):
        sl = slice(s, min(s + batch_size, n))
        t_b = 0.0 if batch_times_s is None else batch_times_s[k]
        comm = L.comm_time(profile, deepest, network=network, t=t_b)
        out.append(
            BatchOutcome(
                time_s=float((t[sl] + comm * cloud[sl]).mean()),
                accuracy=float(correct[sl].mean()),
                on_device_frac=float((serve[sl] >= 0).mean()),
            )
        )
    return out


def missed_deadline_probability(
    outcomes: Sequence[BatchOutcome], t_tar: float, p_tar: float
) -> float:
    """P(batch time > t_tar OR batch accuracy < p_tar) -- paper Sec. IV-E."""
    miss = [o.time_s > t_tar or o.accuracy < p_tar for o in outcomes]
    return float(np.mean(miss))


def missed_deadline_curve(outcomes, t_tars, p_tar):
    return [missed_deadline_probability(outcomes, t, p_tar) for t in t_tars]
