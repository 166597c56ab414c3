"""Adaptive partition-point selection (Neurosurgeon-style, paper Sec. I-II).

Port of `repro.core.partition`. Given per-layer edge/cloud compute
latencies and per-boundary payload sizes, choose the partition layer
(equivalently, which early exit to place on the edge) that minimizes
expected end-to-end latency. The offloading probability at each
candidate exit comes from the calibrated confidence distribution of a
validation pass (K1 on the card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch

from repro_torch.core.exits import gate_statistics


@dataclass
class PartitionCandidate:
    exit_index: int
    partition_layer: int  # model layer after which the split happens
    edge_time_s: float  # time to run layers [0..partition] + exit head
    cloud_time_s: float  # time to run remaining layers on the cloud
    payload_bytes: int  # activation size shipped when offloading
    offload_prob: float  # P(confidence < p_tar) at this exit (calibrated)
    expected_latency_s: float


def expected_latency(
    edge_time_s: float,
    cloud_time_s: float,
    payload_bytes: int,
    offload_prob: float,
    uplink_bps: float,
    comm_wait_factor: float = 1.0,
) -> float:
    """Neurosurgeon objective. `comm_wait_factor` scales the transfer term
    for contention on a shared link (1.0 = the paper's uncontended link)."""
    comm = payload_bytes * 8.0 / uplink_bps
    return edge_time_s + offload_prob * (comm * comm_wait_factor + cloud_time_s)


def choose_partition(
    exit_logits_list,
    temperatures: Sequence[float] = None,
    p_tar: float = None,
    edge_times_s: Sequence[float] = (),
    cloud_times_s: Sequence[float] = (),
    payload_bytes: Sequence[int] = (),
    exit_layer_indices: Sequence[int] = (),
    uplink_bps: float = 18.8e6,
    plan=None,
) -> List[PartitionCandidate]:
    """Rank candidate partitions by expected latency. First entry wins.

    Calibration comes either from `plan` (the offload probability at each
    exit uses that exit's CalibratorState and the plan's p_tar) or from
    the legacy `temperatures` list with an explicit `p_tar`.
    """
    if plan is not None:
        if p_tar is None:
            p_tar = plan.p_tar
    elif temperatures is None or p_tar is None:
        raise ValueError("choose_partition needs (temperatures, p_tar) or plan")
    cands = []
    for i, logits in enumerate(exit_logits_list):
        if plan is not None:
            conf, _, _ = gate_statistics(plan.calibrated_logits(logits, i))
        else:
            conf, _, _ = gate_statistics(logits, temperatures[i])
        # count / n in float64, as numpy's mean of a bool array gives it
        offload_prob = int(torch.count_nonzero(conf < p_tar)) / conf.numel()
        lat = expected_latency(
            edge_times_s[i], cloud_times_s[i], payload_bytes[i], offload_prob, uplink_bps
        )
        cands.append(
            PartitionCandidate(
                exit_index=i,
                partition_layer=exit_layer_indices[i],
                edge_time_s=edge_times_s[i],
                cloud_time_s=cloud_times_s[i],
                payload_bytes=payload_bytes[i],
                offload_prob=offload_prob,
                expected_latency_s=lat,
            )
        )
    return sorted(cands, key=lambda c: c.expected_latency_s)


def select_partition(
    plan,
    exit_logits_list,
    edge_times_s: Sequence[float],
    cloud_times_s: Sequence[float],
    payload_bytes: Sequence[int],
    exit_layer_indices: Sequence[int],
    uplink_bps: float,
):
    """Choose the latency-optimal partition and record it in the plan.

    Returns (plan', candidates): plan' is a copy of `plan` with exit_index
    and partition_layer set from the winning candidate.
    """
    cands = choose_partition(
        exit_logits_list,
        edge_times_s=edge_times_s,
        cloud_times_s=cloud_times_s,
        payload_bytes=payload_bytes,
        exit_layer_indices=exit_layer_indices,
        uplink_bps=uplink_bps,
        plan=plan,
    )
    best = cands[0]
    return plan.with_partition(best.exit_index, best.partition_layer), cands
