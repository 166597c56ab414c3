"""The shared controller core: one control plane for both serving stacks.

The paper's loop -- calibrate offline, gate on calibrated confidence at
serve time, and adapt the deployed (branch, p_tar) when conditions move
-- used to be implemented twice: the event-driven `ServingRuntime` path
(`repro.serving.controller.OnlineController`) and the fleet path
(`repro.fleet.controller.FleetController`) each carried their own
candidate-table construction, plan re-scoring, and telemetry reductions.
This module is the single home for the pieces both share:

* `rescore_plan` -- the Edgent-style candidate table (re-used calibrators,
  measured bandwidth, M/M/1 uplink correction, optional per-sample mix
  weights). Moved here from `repro.core.policy`, which keeps a re-export.
  Each row now also prices the paper's reliability contract: the
  candidate's estimated ON-DEVICE accuracy and ``reliability_gap``
  |on-device accuracy - p_tar|, so a controller can refuse candidates
  that would silently break calibration.
* selection rules -- `row_feasible` / `select_candidate` (accuracy floor
  + reliability-gap cap, latency-greedy among feasible, graceful
  degradation), `hold_incumbent` (hysteresis), and
  `choose_with_concession` (the distress-gated p_tar concession:
  hold the operator's contract while the link can carry it, otherwise
  make the WEAKEST stable concession).
* `ControllerCore` -- owns the validation blocks (context-blind or
  per-context), the once-per-run calibrated exit statistics, the latency
  profile columns, and the mix -> per-sample-weight mapping that makes a
  re-score CONTEXT-AWARE (validation samples weighted by the traffic mix
  a telemetry window actually observed).
* shared telemetry primitives -- `latency_stats_ms`, `on_device_gap`,
  and the windowed estimators (`windowed_mean`, `windowed_rate`,
  `windowed_mix`) that both `repro.serving.telemetry.Telemetry` and
  `repro.fleet.telemetry.FleetTelemetry` answer control questions with,
  so the two stacks cannot disagree about what an estimate means.

Port of `repro.core.control`. Everything here is host numpy, as in the
reference, except the gate statistics (`OffloadPlan.gate_block`, K1 on
the card) and the codec accuracy axis: where the reference round-trips
the final logits through the `kernels.ref` oracle, the port runs
`kernels.compress.roundtrip`, which on the card is K3/K4 and on a CPU
tensor the plain version.

`OnlineController` and `FleetController` are thin policy layers over this
core: the event controller adds queue-aware edge-time inflation and
hysteresis, the fleet controller adds per-cell iteration, distress
gating, and the shared-cloud utilization cap.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch._device import as_tensor, to_numpy


# ------------------------------------------------ shared telemetry primitives
def latency_stats_ms(latencies_s: np.ndarray) -> Dict[str, float]:
    """p50/p95/p99/mean in ms from an array of per-request latencies --
    the one definition of the repo's latency roll-up, shared by the
    event-driven `Telemetry` and the fleet-scale aggregator."""
    lat = np.asarray(latencies_s, np.float64)
    if lat.size == 0:
        nan = float("nan")
        return {"p50_ms": nan, "p95_ms": nan, "p99_ms": nan, "mean_ms": nan}
    p50, p95, p99 = np.percentile(lat, [50, 95, 99])
    return {
        "p50_ms": float(p50) * 1e3,
        "p95_ms": float(p95) * 1e3,
        "p99_ms": float(p99) * 1e3,
        "mean_ms": float(lat.mean()) * 1e3,
    }


def on_device_gap(correct: np.ndarray, p_tar: np.ndarray) -> Optional[float]:
    """|on-device accuracy - mean p_tar in force| for one regime group --
    the paper's reliability contract, measured where it is made: on the
    samples the gate kept on the device. None for an empty group."""
    correct = np.asarray(correct, np.float64)
    if correct.size == 0:
        return None
    return abs(float(correct.mean()) - float(np.mean(p_tar)))


def windowed_mean(
    times,
    values,
    window_s: Optional[float] = None,
    now: Optional[float] = None,
    stale_fallback: bool = True,
) -> Optional[float]:
    """Mean of the (t, value) observations in the trailing window.

    With no window (or no `now`), the mean over everything. With
    `stale_fallback`, an empty window falls back to the single nearest
    observation: the most recent one at or before `now`, or -- when every
    observation post-dates `now`, as happens on a congested fleet cell
    whose in-flight transfers are priced at their future ready times --
    the earliest upcoming one (stale beats assuming the nominal best
    case -- the bandwidth-estimate contract). Without `stale_fallback`,
    an empty window is None (the queue-estimate contract). None only
    when nothing was ever observed."""
    t = np.asarray(times, np.float64)
    v = np.asarray(values, np.float64)
    if t.size == 0:
        return None
    if window_s is None or now is None:
        return float(v.mean())
    past = t <= now
    in_win = past & (t >= now - window_s)
    if in_win.any():
        return float(v[in_win].mean())
    if not stale_fallback:
        return None
    if past.any():
        return float(v[past][np.argmax(t[past])])
    return float(v[np.argmin(t)])


def windowed_rate(times, window_s: float, now: float) -> Optional[float]:
    """Arrivals/second over the trailing window (None if no arrival
    landed in it). A run younger than the window divides by the elapsed
    time instead, so early estimates aren't biased low."""
    t = np.asarray(times, np.float64)
    n = int(((t >= now - window_s) & (t <= now)).sum())
    if n == 0:
        return None
    return n / max(min(window_s, now), 1e-9)


def windowed_mix(
    times, ids, n_keys: int, window_s: float, now: float
) -> Optional[np.ndarray]:
    """Share of the trailing window's observations per key id ->
    (n_keys,) weights summing to 1, or None when nothing (recognizable)
    was observed. Negative ids (unrecognized-context verdicts) are
    excluded: the bank serves them with the default plan, but their gate
    statistics belong to no fitted context."""
    t = np.asarray(times, np.float64)
    v = np.asarray(ids, np.int64)
    m = (t >= now - window_s) & (t <= now) & (v >= 0)
    if not m.any():
        return None
    counts = np.bincount(v[m], minlength=n_keys)
    return counts / counts.sum()


# ----------------------------------------------------- online re-scoring
def rescore_plan(
    plan,
    exit_logits_list,
    edge_times_s: Sequence[float],
    cloud_times_s: Sequence[float],
    payload_bytes: Sequence[int],
    uplink_bps: float,
    labels=None,
    final_logits=None,
    p_tar_grid: Optional[Sequence[float]] = None,
    min_accuracy: Optional[float] = None,
    exit_layer_indices: Optional[Sequence[int]] = None,
    arrival_rate_hz: Optional[float] = None,
    exit_stats: Optional[Sequence] = None,
    sample_weight=None,
    max_reliability_gap: Optional[float] = None,
    compression_levels: Optional[Sequence[int]] = None,
    final_correct_by_level: Optional[Dict[int, np.ndarray]] = None,
    branches: Optional[Sequence[int]] = None,
    device=None,
):
    """Re-select (deployed exit, effective p_tar, codec level) under
    CURRENT conditions.

    `branches` restricts the candidate table to the given physical
    branches (1-based, matching `exit_logits_list` order); None scores
    every branch. Pinning the deployed branch with `p_tar_grid=None`
    leaves the codec level as the only axis.

    Edgent-style adaptation: the plan's fitted per-exit calibrators are
    re-used as-is (no re-fitting); only the offload probability and the
    expected-latency objective are re-evaluated at the measured
    `uplink_bps`. With `labels` and `final_logits`, each candidate's
    end-to-end accuracy (on-device samples by the exit head, offloaded
    samples by the cloud main head) is computed and candidates below
    `min_accuracy` are rejected; if none qualify, the most accurate
    candidate wins regardless of latency.

    `arrival_rate_hz` (fleet-wide, for a SHARED uplink) adds an M/M/1-style
    busy-ratio correction: a candidate whose offloads would load the link
    at utilization rho sees its comm term scaled by 1/(1-rho), capped at
    100x past saturation -- without it, the open-loop objective happily
    picks configurations whose offload traffic exceeds link capacity.

    `exit_stats` skips the calibrate+softmax pass: a list of per-exit
    (confidence, prediction) arrays already computed with this plan's
    calibrators (they don't change between re-scores, so a periodic
    controller computes them once and passes them every tick).

    `sample_weight` (length-N, renormalized internally) weights the
    validation samples when computing each candidate's offload probability
    and accuracy. This is how a context-aware controller re-scores under
    input drift: concatenate per-context validation logits and weight each
    context's block by its estimated share of recent traffic, so the
    candidate table prices the traffic mix actually being served rather
    than the clean distribution (see `ControllerCore.sample_weight_for_mix`).

    With labels, each row also carries ``on_device_accuracy`` (accuracy of
    the exit head on the samples the candidate keeps on-device) and
    ``reliability_gap`` = |on_device_accuracy - p_tar| -- the candidate's
    estimated miscalibration under the (weighted) validation traffic.
    `max_reliability_gap` makes that a feasibility constraint alongside
    `min_accuracy`: candidates estimated to break the paper's reliability
    contract by more than the cap are rejected; if none survive, the
    accuracy-feasible row with the smallest gap wins (the contract
    degrades as little as possible).

    `compression_levels` adds the payload-codec axis: the candidate table
    becomes branch x p_tar x level, each row priced at that level's
    analytic wire bytes (comm term, M/M/1 utilization) and, with labels,
    at its measured accuracy delta -- offloaded samples score against
    `final_correct_by_level[level]` (cloud correctness after the payload
    round-trips the codec; computed here from `final_logits` through
    `kernels.compress.roundtrip` when not supplied pre-computed). None (the
    default) is exactly the legacy level-0-only table, and the level loop
    is innermost so legacy row order is preserved. The reliability gap is
    level-independent (the gate runs before the codec), so
    `max_reliability_gap` bounds every level equally.

    Logits that are not tensors land on `device` (``cuda`` by default)
    for the gate and the codec; tensors stay on their own device.

    Returns (new_plan, table): new_plan carries the winning exit_index,
    p_tar, and compression_level; table lists every candidate as a dict,
    best first.
    """
    from repro_torch.core.partition import expected_latency

    if plan.criterion != "confidence":
        raise ValueError(
            "rescore_plan moves the confidence target p_tar; an "
            f"{plan.criterion!r}-criterion plan has nothing to re-score"
        )
    if min_accuracy is not None and (labels is None or final_logits is None):
        raise ValueError(
            "min_accuracy needs labels and final_logits to evaluate "
            "candidate accuracy"
        )
    if max_reliability_gap is not None and labels is None:
        raise ValueError(
            "max_reliability_gap needs labels to estimate each candidate's "
            "on-device accuracy"
        )
    grid = [plan.p_tar] if p_tar_grid is None else list(p_tar_grid)
    levels = (
        (0,) if compression_levels is None
        else tuple(int(l) for l in compression_levels)
    )
    y = None if labels is None else to_numpy(labels)
    final_correct = None
    if final_logits is not None and y is not None:
        final_correct = np.argmax(to_numpy(final_logits), axis=-1) == y
    # per-level cloud correctness: level 0 is the untouched legacy array
    fc_by_level: Dict[int, Optional[np.ndarray]] = {0: final_correct}
    if final_correct_by_level is not None:
        for l, v in final_correct_by_level.items():
            fc_by_level.setdefault(int(l), None if v is None else np.asarray(v))
    for l in levels:
        if l in fc_by_level:
            continue
        if final_logits is not None and y is not None:
            from repro_torch.kernels.compress import roundtrip

            fc_by_level[l] = (
                np.argmax(to_numpy(roundtrip(as_tensor(final_logits, device), l)),
                          axis=-1) == y
            )
        else:
            fc_by_level[l] = None
    if any(l != 0 for l in levels):
        from repro_torch.kernels.compress import scaled_payload_nbytes
    w = None
    if sample_weight is not None:
        w = np.asarray(sample_weight, np.float64)
        if w.ndim != 1 or np.any(w < 0) or w.sum() <= 0:
            raise ValueError("sample_weight must be 1-D, non-negative, sum > 0")
    branch_set = None
    if branches is not None:
        branch_set = {int(b) for b in branches}
        known = set(range(1, len(exit_logits_list) + 1))
        if not branch_set or not branch_set <= known:
            raise ValueError(
                f"branches {sorted(branch_set)} outside the fitted "
                f"branches {sorted(known)}"
            )
    table = []
    for i, z in enumerate(exit_logits_list):
        if branch_set is not None and (i + 1) not in branch_set:
            continue
        if exit_stats is not None:
            conf, pred = exit_stats[i]
        else:
            conf, pred = plan.gate_block(as_tensor(z, device), branch=i)
        conf, pred = to_numpy(conf), to_numpy(pred)
        exit_correct = None if y is None else pred == y
        for p in grid:
            on = conf >= p
            offload_prob = float(np.average(~on, weights=w))
            on_acc = gap = None
            if exit_correct is not None:
                w_on = None if w is None else w[on]
                if on.any() and (w_on is None or w_on.sum() > 0):
                    on_acc = float(np.average(exit_correct[on], weights=w_on))
                    gap = abs(on_acc - float(p))
            for lvl in levels:
                # level 0 keeps the caller's object so legacy pricing is
                # bit-identical; other levels use the analytic wire size
                pb = (
                    payload_bytes[i] if lvl == 0
                    else scaled_payload_nbytes(payload_bytes[i], lvl)
                )
                comm = pb * 8.0 / uplink_bps
                utilization = (
                    arrival_rate_hz * offload_prob * comm
                    if arrival_rate_hz is not None
                    else 0.0
                )
                wait_factor = 1.0 / max(1.0 - utilization, 1e-2)
                lat = expected_latency(
                    edge_times_s[i], cloud_times_s[i], pb,
                    offload_prob, uplink_bps, comm_wait_factor=wait_factor,
                )
                fc = fc_by_level.get(lvl)
                acc = None
                if exit_correct is not None and fc is not None:
                    acc = float(np.average(np.where(on, exit_correct, fc),
                                           weights=w))
                table.append(
                    dict(
                        exit_index=i,
                        p_tar=float(p),
                        compression_level=int(lvl),
                        offload_prob=offload_prob,
                        expected_latency_s=lat,
                        uplink_utilization=utilization,
                        uplink_nbytes=float(pb) * offload_prob,
                        accuracy=acc,
                        on_device_accuracy=on_acc,
                        reliability_gap=gap,
                    )
                )
    best = select_candidate(
        table, min_accuracy=min_accuracy,
        max_reliability_gap=max_reliability_gap,
    )
    table = sorted(table, key=lambda r: r["expected_latency_s"])
    if exit_layer_indices is not None:
        layer = exit_layer_indices[best["exit_index"]]
    elif best["exit_index"] == plan.exit_index:
        layer = plan.partition_layer
    else:  # exit moved and we don't know its layer: don't keep a stale one
        layer = None
    new_plan = (
        plan.with_partition(best["exit_index"], layer)
        .with_p_tar(best["p_tar"])
        .with_compression(best.get("compression_level", 0))
    )
    return new_plan, table


# ----------------------------------------------------------- selection rules
def row_feasible(
    row: dict,
    min_accuracy: Optional[float] = None,
    max_reliability_gap: Optional[float] = None,
) -> bool:
    """The shared feasibility test: the accuracy floor and (when capped)
    the estimated reliability-gap contract."""
    if min_accuracy is not None and not (
        row["accuracy"] is not None and row["accuracy"] >= min_accuracy
    ):
        return False
    if max_reliability_gap is not None:
        gap = row.get("reliability_gap")
        if gap is None:
            # an all-offload candidate keeps nothing on the device, so the
            # on-device contract is vacuously held; a gap unknown for any
            # other reason is not trusted
            if row.get("offload_prob") != 1.0:
                return False
        elif gap > max_reliability_gap:
            return False
    return True


def select_candidate(
    table: List[dict],
    min_accuracy: Optional[float] = None,
    max_reliability_gap: Optional[float] = None,
) -> dict:
    """Latency-greedy among feasible rows, degrading gracefully: no row
    under the gap cap -> the accuracy-feasible row with the smallest
    estimated gap; nothing meets the accuracy floor -> most accurate."""
    feasible = [
        r for r in table if row_feasible(r, min_accuracy, max_reliability_gap)
    ]
    if feasible:
        return min(feasible, key=lambda r: r["expected_latency_s"])
    if max_reliability_gap is not None:
        acc_ok = [
            r for r in table
            if row_feasible(r, min_accuracy)
            and r.get("reliability_gap") is not None
        ]
        if acc_ok:
            return min(
                acc_ok,
                key=lambda r: (r["reliability_gap"], r["expected_latency_s"]),
            )
    return max(table, key=lambda r: (r["accuracy"] or 0.0))


def _row_for(table: List[dict], plan) -> Optional[dict]:
    level = int(getattr(plan, "compression_level", 0))
    return next(
        (
            r for r in table
            if r["exit_index"] == plan.exit_index
            and r["p_tar"] == plan.p_tar
            and r.get("compression_level", 0) == level
        ),
        None,
    )


def hold_incumbent(
    table: List[dict],
    incumbent,
    candidate,
    hysteresis: float,
    min_accuracy: Optional[float] = None,
    max_reliability_gap: Optional[float] = None,
) -> bool:
    """True when the incumbent plan should be retained: it is still
    feasible under current conditions and the ADOPTED candidate's latency
    gain is below the hysteresis margin. An incumbent that itself
    violates the feasibility constraints is never retained."""
    cur = _row_for(table, incumbent)
    new = _row_for(table, candidate)
    return (
        cur is not None
        and row_feasible(cur, min_accuracy, max_reliability_gap)
        and new is not None
        and new["expected_latency_s"]
        > (1.0 - hysteresis) * cur["expected_latency_s"]
    )


def choose_with_concession(
    table: List[dict],
    contract_p_tar: float,
    distress_utilization: float,
    min_accuracy: Optional[float] = None,
    max_reliability_gap: Optional[float] = None,
    force_concession: bool = False,
) -> dict:
    """Distress-gated p_tar concession (the fleet's per-cell rule).

    1. If a feasible candidate at the CONTRACT p_tar keeps the uplink
       under the distress threshold, take the fastest such row (the
       branch is the only knob, as in the single-cell scenario).
    2. Otherwise the link cannot carry full-p_tar traffic: make the
       weakest reliability concession -- among stable feasible rows,
       the highest p_tar, fastest within it.
    3. No stable row at all: fastest feasible; no feasible row: most
       accurate (the `rescore_plan` degradation rule).

    `force_concession` is the QoS monitor's distress override: a cell
    whose declared SLO has TRIPPED stops holding the operator's contract
    p_tar (stage 1 is skipped) and takes the fastest stable feasible
    row -- the rescue configuration -- until the monitor clears it. The
    model-side feasibility caps (`min_accuracy`, `max_reliability_gap`)
    still bind; only the latency-vs-contract preference flips.
    """
    feasible = [
        r for r in table if row_feasible(r, min_accuracy, max_reliability_gap)
    ]
    if not force_concession:
        full = [
            r for r in feasible
            if r["p_tar"] == contract_p_tar
            and r["uplink_utilization"] < distress_utilization
        ]
        if full:
            return min(full, key=lambda r: r["expected_latency_s"])
    stable = [
        r for r in feasible if r["uplink_utilization"] < distress_utilization
    ]
    if stable:
        if force_concession:
            return min(stable, key=lambda r: r["expected_latency_s"])
        return min(stable, key=lambda r: (-r["p_tar"], r["expected_latency_s"]))
    if feasible:
        return min(feasible, key=lambda r: r["expected_latency_s"])
    return max(table, key=lambda r: (r["accuracy"] or 0.0))


# ----------------------------------------------------------- shared config
@dataclass
class ControlConfig:
    """Fields every controller shares; the serving / fleet configs extend
    this with their stack-specific knobs."""

    interval_s: float = 1.0  # re-score cadence (simulated seconds)
    window_s: float = 2.0  # trailing telemetry window
    p_tar_grid: Optional[Sequence[float]] = None  # None = keep the plan's
    branches: Optional[Sequence[int]] = None  # physical branches (1-based)
    # to score; None = every fitted branch. Pinning the branch (and
    # leaving p_tar_grid=None) isolates the codec axis: the controller
    # moves ONLY the payload wire format of a fixed split.
    min_accuracy: Optional[float] = None  # accuracy floor for candidates
    max_reliability_gap: Optional[float] = None  # estimated-gap cap
    hysteresis: float = 0.05  # min relative latency gain to switch
    utilization_aware: bool = True  # M/M/1 uplink correction from arrivals
    distress_utilization: float = 0.95  # uplink rho above which a cell may
    # concede p_tar (see `choose_with_concession`)
    compression_levels: Optional[Sequence[int]] = None  # payload codec
    # levels to score (None = level 0 only, the bytes-blind legacy table)


# ------------------------------------------------------- the controller core
class ControllerCore:
    """Validation blocks + cached gate statistics + the mix-weighted
    re-score -- everything a controller needs that is not policy.

    `exit_logits` is either ``{physical_branch: (N, C)}`` (context-blind:
    the single-cell controller's original form) or ``{context: {branch:
    (N, C)}}`` with matching per-context `final_logits`, which makes
    `rescore` CONTEXT-AWARE: per-context blocks are concatenated once,
    and a tick only supplies per-sample weights derived from an observed
    traffic mix (`sample_weight_for_mix`). `labels` is shared across
    contexts (the usual case: the same validation samples, distorted per
    context). A `PlanBank` contributes its default plan -- bandwidth-
    driven re-scoring and per-sample expert selection compose without
    touching each other's state.
    """

    def __init__(
        self,
        plan,
        profile,
        exit_logits: Dict,
        final_logits=None,
        labels: Optional[np.ndarray] = None,
        payload_nbytes=None,
        backend=None,
        compression_levels: Optional[Sequence[int]] = None,
    ):
        from repro_torch.core.bank import PlanBank
        from repro_torch.core.gatepath import get_gate_backend
        from repro_torch.offload import latency as L

        if isinstance(plan, PlanBank):
            plan = plan.default_plan
        if plan.criterion != "confidence":
            raise ValueError(
                "the controller core re-scores the confidence target p_tar; "
                f"{plan.criterion!r}-criterion plans are not re-scorable"
            )
        self.plan = plan
        self.profile = profile
        self.backend = get_gate_backend(backend)

        # normalize to {context: {branch: logits}}; None key = context-blind
        if all(isinstance(k, str) for k in exit_logits):
            by_ctx = {k: exit_logits[k] for k in sorted(exit_logits)}
            if final_logits is not None and not isinstance(final_logits, dict):
                raise ValueError(
                    "per-context exit_logits need per-context final_logits"
                )
            final_by_ctx = final_logits
        else:
            by_ctx = {None: exit_logits}
            final_by_ctx = None if final_logits is None else {None: final_logits}
        self.ctx_keys: List[Optional[str]] = list(by_ctx)
        first = next(iter(by_ctx.values()))
        self.branches = sorted(first)
        if self.branches != list(range(1, len(self.branches) + 1)):
            raise ValueError(
                "exit_logits keys must be contiguous physical branches 1..K "
                "(branch k gates with plan.calibrators[k-1]); got "
                f"{self.branches}"
            )
        for ctx, per_branch in by_ctx.items():
            if sorted(per_branch) != self.branches:
                raise ValueError(f"context {ctx!r} covers different branches")

        self.labels = None if labels is None else to_numpy(labels)
        if payload_nbytes is None:
            from repro_torch.models.convnet import payload_bytes

            payload_nbytes = payload_bytes
        self.payload_bytes = [payload_nbytes(b) for b in self.branches]
        self.edge_times_s = [L.edge_time(profile, b) for b in self.branches]
        self.cloud_times_s = [L.cloud_time(profile, b) for b in self.branches]

        # calibrated (conf, pred) never change between ticks: compute once
        # per (context, branch), concatenated in ctx_keys order so a tick
        # only supplies per-sample weights
        self._block_len = [len(next(iter(by_ctx[k].values()))) for k in self.ctx_keys]
        self.exit_logits_list = [
            np.concatenate([to_numpy(by_ctx[k][b]) for k in self.ctx_keys])
            for b in self.branches
        ]
        self._exit_stats = []
        for bi, b in enumerate(self.branches):
            stats = [
                self.backend.plan_gate_block(plan, by_ctx[k][b], branch=bi)
                for k in self.ctx_keys
            ]
            self._exit_stats.append(
                (np.concatenate([c for c, _ in stats]),
                 np.concatenate([p for _, p in stats]))
            )
        if self.labels is not None:
            self._labels_cat = np.concatenate(
                [self.labels for _ in self.ctx_keys]
            )
        else:
            self._labels_cat = None
        if final_by_ctx is not None:
            missing = set(self.ctx_keys) - set(final_by_ctx)
            if missing:
                raise ValueError(f"final_logits missing contexts {sorted(missing)}")
            self._final_cat = np.concatenate(
                [to_numpy(final_by_ctx[k]) for k in self.ctx_keys]
            )
        else:
            self._final_cat = None

        # payload-codec axis: measure each non-zero level's accuracy delta
        # ONCE at construction (cloud correctness after the concatenated
        # final logits round-trip the codec on the backend's device) so a
        # tick only prices it
        self.compression_levels = (
            (0,) if compression_levels is None
            else tuple(int(l) for l in compression_levels)
        )
        self._final_correct_by_level: Optional[Dict[int, np.ndarray]] = None
        nonzero = [l for l in self.compression_levels if l != 0]
        if nonzero and self._labels_cat is not None and self._final_cat is not None:
            from repro_torch.kernels.compress import roundtrip

            self._final_correct_by_level = {
                l: np.argmax(
                    to_numpy(roundtrip(self._final_cat, l, device=self.backend.device)),
                    axis=-1,
                ) == self._labels_cat
                for l in nonzero
            }

    @property
    def context_aware(self) -> bool:
        return self.ctx_keys != [None]

    @property
    def has_labels(self) -> bool:
        return self._labels_cat is not None

    def sample_weight_for_mix(
        self, mix: Optional[Dict[str, float]]
    ) -> Optional[np.ndarray]:
        """Per-sample weights pricing an observed traffic mix ({context:
        share}); None (uniform over all contexts' samples) when the core
        is context-blind, the mix is empty, or no observed context
        matches a fitted block."""
        if mix is None or not self.context_aware:
            return None
        w_ctx = np.asarray([max(mix.get(k, 0.0), 0.0) for k in self.ctx_keys])
        if w_ctx.sum() <= 0:
            return None
        w_ctx = w_ctx / w_ctx.sum()
        return np.concatenate(
            [np.full(n, m / n) for n, m in zip(self._block_len, w_ctx)]
        )

    def rescore(
        self,
        plan,
        uplink_bps: float,
        edge_times_s: Optional[Sequence[float]] = None,
        arrival_rate_hz: Optional[float] = None,
        p_tar_grid: Optional[Sequence[float]] = None,
        min_accuracy: Optional[float] = None,
        max_reliability_gap: Optional[float] = None,
        sample_weight=None,
        compression_levels: Optional[Sequence[int]] = None,
        branches: Optional[Sequence[int]] = None,
    ) -> Tuple[Any, List[dict]]:
        """One candidate table under measured conditions; `plan` is the
        current deployment (same calibrators as at construction -- the
        cached exit statistics assume it). `compression_levels` defaults
        to the levels fixed at construction (whose accuracy deltas are
        pre-measured)."""
        levels = (
            self.compression_levels if compression_levels is None
            else tuple(int(l) for l in compression_levels)
        )
        return rescore_plan(
            plan,
            self.exit_logits_list,
            edge_times_s=self.edge_times_s if edge_times_s is None else edge_times_s,
            cloud_times_s=self.cloud_times_s,
            payload_bytes=self.payload_bytes,
            uplink_bps=uplink_bps,
            labels=self._labels_cat,
            final_logits=self._final_cat,
            p_tar_grid=p_tar_grid,
            min_accuracy=min_accuracy,
            max_reliability_gap=max_reliability_gap,
            arrival_rate_hz=arrival_rate_hz,
            exit_stats=self._exit_stats,
            sample_weight=sample_weight,
            compression_levels=levels,
            final_correct_by_level=self._final_correct_by_level,
            branches=branches,
        )
