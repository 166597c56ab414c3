"""Drifting input conditions for the serving runtime.

`network` gives the runtime drifting *networks* (Markov Wi-Fi, trace replay);
this module adds the third workload axis: drifting *inputs*. A
`ContextSchedule` maps simulated time to a distortion context key (the
camera fogs up at t=40s, clears at t=90s), and `ContextualLogitsCore`
serves per-context precomputed logits through that schedule -- so a
request gated at time t sees the logits its branch would have produced on
inputs distorted by the context in force at t.

Plan selection is the edge device's problem, not the oracle's: when the
core is built from a `PlanBank` with an embedded estimator, each sample's
expert plan is chosen from the estimator's verdict on that sample's cheap
input statistics (`repro_torch.data.distortion.input_features`), NOT from the
true scheduled context. Estimator mistakes therefore cost exactly what
they would cost on a real device: gating with the wrong expert's
calibrator. Telemetry records both the true and the estimated context per
request, so `Telemetry.per_context_summary` can report the confusion.

Both schedule types are deterministic under their seed, matching the
repo-wide reproducibility contract:

* `PiecewiseSchedule` -- explicit (start time, context) segments;
* `MarkovContextSchedule` -- a Markov chain over contexts advancing once
  per dwell slot (slot states materialized sequentially, like
  `MarkovNetwork`), modeling weather-style regime drift.

Port of `repro.serving.drift`. The schedules are host numpy; the
contextual core's gate blocks go through the selected `GateBackend`
(``"torch"`` by default: one K1 launch per (context, plan key, branch)
on the card at construction), and a non-zero codec level's cloud table
round-trips each context's final logits through the codec on the
backend's device (one K3 and one K4 launch per new (level, context)).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch._device import to_numpy
from repro_torch.core.bank import PlanBank
from repro_torch.core.gatepath import get_gate_backend
from repro_torch.core.policy import OffloadPlan
from repro_torch.kernels.compress import roundtrip


# ------------------------------------------------------- context schedules
class ContextSchedule:
    """Maps simulated time -> the distortion context key in force."""

    def context_at(self, t: float) -> str:
        raise NotImplementedError

    def context_ids_at(self, times) -> np.ndarray:
        """Vectorized lookup -> (N,) int64 indices into `contexts`. The
        base implementation loops over `context_at`; both schedule types
        override it with one indexing op (the fleet simulator resolves
        whole event windows through this)."""
        index = {k: i for i, k in enumerate(self.contexts)}
        t = np.asarray(times, np.float64)
        return np.asarray(
            [index[self.context_at(float(x))] for x in t.ravel()], np.int64
        ).reshape(t.shape)

    @property
    def contexts(self) -> List[str]:
        raise NotImplementedError


class PiecewiseSchedule(ContextSchedule):
    """Explicit regime segments: [(start_s, context), ...], start times
    sorted and beginning at 0; segment i holds until segment i+1 starts."""

    def __init__(self, segments: Sequence[Tuple[float, str]]):
        if not segments:
            raise ValueError("need at least one segment")
        starts = [float(t) for t, _ in segments]
        if starts[0] != 0.0 or any(b <= a for a, b in zip(starts, starts[1:])):
            raise ValueError("segment starts must begin at 0 and strictly increase")
        self.starts = np.asarray(starts, np.float64)
        self.keys = [k for _, k in segments]

    def context_at(self, t: float) -> str:
        i = int(np.searchsorted(self.starts, max(float(t), 0.0), side="right")) - 1
        return self.keys[max(i, 0)]

    def context_ids_at(self, times) -> np.ndarray:
        t = np.maximum(np.asarray(times, np.float64), 0.0)
        seg = np.maximum(np.searchsorted(self.starts, t, side="right") - 1, 0)
        index = {k: i for i, k in enumerate(self.contexts)}
        seg_to_ctx = np.asarray([index[k] for k in self.keys], np.int64)
        return seg_to_ctx[seg]

    @property
    def contexts(self) -> List[str]:
        return sorted(set(self.keys))


class MarkovContextSchedule(ContextSchedule):
    """Markov regime drift: every `dwell_s` the chain either stays in the
    current context (prob `p_stay`) or jumps uniformly to another one; an
    explicit row-stochastic `transition` matrix overrides that default.
    Slot states are materialized sequentially from the seed, so
    `context_at` is deterministic regardless of query order."""

    def __init__(
        self,
        contexts: Sequence[str],
        dwell_s: float = 10.0,
        p_stay: float = 0.7,
        transition: Optional[np.ndarray] = None,
        seed: int = 0,
        start_context: Optional[str] = None,
    ):
        if dwell_s <= 0:
            raise ValueError("dwell_s must be positive")
        if len(contexts) != len(set(contexts)) or not contexts:
            raise ValueError("contexts must be a non-empty list of unique keys")
        self._contexts = list(contexts)
        k = len(self._contexts)
        if transition is None:
            if not 0.0 <= p_stay <= 1.0:
                raise ValueError("p_stay must be in [0, 1]")
            off = (1.0 - p_stay) / max(k - 1, 1)
            transition = np.full((k, k), off)
            np.fill_diagonal(transition, p_stay if k > 1 else 1.0)
        transition = np.asarray(transition, np.float64)
        if transition.shape != (k, k) or not np.allclose(transition.sum(axis=1), 1.0):
            raise ValueError(f"transition must be row-stochastic ({k}, {k})")
        self.transition = transition
        self.dwell_s = float(dwell_s)
        self._rng = np.random.default_rng(seed)
        start = 0 if start_context is None else self._contexts.index(start_context)
        self._states = [start]

    def _state(self, slot: int) -> int:
        while len(self._states) <= slot:
            row = self.transition[self._states[-1]]
            self._states.append(int(self._rng.choice(len(row), p=row)))
        return self._states[slot]

    def context_at(self, t: float) -> str:
        slot = int(max(float(t), 0.0) // self.dwell_s)
        return self._contexts[self._state(slot)]

    def context_ids_at(self, times) -> np.ndarray:
        t = np.asarray(times, np.float64)
        slots = (np.maximum(t, 0.0) // self.dwell_s).astype(np.int64)
        if slots.size:
            self._state(int(slots.max()))  # materialize in order, once
        return np.asarray(self._states, np.int64)[slots]

    @property
    def contexts(self) -> List[str]:
        return list(self._contexts)


# -------------------------------------------------- contextual compute core
class ContextualLogitsCore:
    """LogitsCore over per-context logits under a drifting schedule.

    exit_logits_by_context: {context: {physical_branch: (N, C) logits}} --
    the SAME n samples pushed through the model under each context's
    distortion; final_logits_by_context the matching cloud main heads.

    plan_or_bank decides calibration:
      * an `OffloadPlan` applies one calibrator set to every context (the
        single-global-plan baseline, or the uncalibrated one);
      * a `PlanBank` picks the expert plan per sample -- via its embedded
        estimator on `features_by_context` (the honest edge-side path) or,
        with no estimator/features, by the true context (the oracle bound).

    Confidence/prediction are precomputed per (true context, expert plan,
    branch); only the mask depends on the runtime's moving p_tar, so
    controller branch/target switches stay free, exactly as in LogitsCore.
    The precompute routes through the selected `GateBackend`
    (`repro_torch.core.gatepath`), the same execution layer the fleet's dense
    gate table uses. `backend` None is ``"torch"``, which runs on the card
    and raises without one; ``"numpy"`` or ``TorchGateBackend(device="cpu")``
    stay on the host.
    """

    contextual = True

    def __init__(
        self,
        exit_logits_by_context: Dict[str, Dict[int, np.ndarray]],
        final_logits_by_context: Dict[str, np.ndarray],
        plan_or_bank,
        schedule: ContextSchedule,
        labels: Optional[np.ndarray] = None,
        features_by_context: Optional[Dict[str, np.ndarray]] = None,
        backend=None,
    ):
        self.backend = get_gate_backend(backend)
        if isinstance(plan_or_bank, PlanBank):
            self.bank: Optional[PlanBank] = plan_or_bank
            plans = dict(plan_or_bank.plans)
        else:
            self.bank = None
            plans = {"__plan__": plan_or_bank}
        criteria = {p.criterion for p in plans.values()}
        if criteria != {"confidence"}:
            raise ValueError(
                "ContextualLogitsCore gates on the runtime's moving "
                f"confidence target; plan criteria {sorted(criteria)} "
                "are not supported"
            )
        self.schedule = schedule
        self.ctx_keys = sorted(exit_logits_by_context)
        missing = set(schedule.contexts) - set(self.ctx_keys)
        if missing:
            raise ValueError(
                f"schedule visits contexts with no logits: {sorted(missing)}"
            )
        if set(final_logits_by_context) != set(self.ctx_keys):
            raise ValueError("exit and final logits must cover the same contexts")

        self.branches = sorted(next(iter(exit_logits_by_context.values())))
        for ctx, per_branch in exit_logits_by_context.items():
            if sorted(per_branch) != self.branches:
                raise ValueError(f"context {ctx!r} covers different branches")

        # expert selection per (true context, sample)
        self._est: Dict[str, List[str]] = {}
        self._oracle = not (
            self.bank is not None
            and self.bank.estimator is not None
            and features_by_context is not None
        )
        if not self._oracle:
            est = self.bank.estimator
            for ctx in self.ctx_keys:
                if ctx not in features_by_context:
                    raise ValueError(f"no features for context {ctx!r}")
                self._est[ctx] = est.predict_per_sample(features_by_context[ctx])
        else:  # oracle selection (single plans ignore the key anyway)
            n_by_ctx = {
                c: len(next(iter(b.values())))
                for c, b in exit_logits_by_context.items()
            }
            for ctx in self.ctx_keys:
                key = ctx if self.bank is not None else "__plan__"
                self._est[ctx] = [key] * n_by_ctx[ctx]

        # (true ctx, plan key, branch) -> precomputed conf/pred; only plan
        # keys the estimator can actually emit for that context are needed
        self.conf: Dict[tuple, np.ndarray] = {}
        self.pred: Dict[tuple, np.ndarray] = {}
        for ctx in self.ctx_keys:
            needed = set(self._est[ctx])
            for pk in needed:
                plan = plans[pk] if self.bank is None else self.bank.plan_for(pk)
                for b in self.branches:
                    c, p = self.backend.plan_gate_block(
                        plan, exit_logits_by_context[ctx][b], branch=b - 1
                    )
                    self.conf[(ctx, pk, b)] = c
                    self.pred[(ctx, pk, b)] = p
        self.final_pred = {
            ctx: np.argmax(to_numpy(z), axis=-1)
            for ctx, z in final_logits_by_context.items()
        }
        # retained for lazy per-codec-level cloud tables (see cloud_predict)
        self._final_logits = {
            ctx: to_numpy(z) for ctx, z in final_logits_by_context.items()
        }
        self._final_pred_by_level: Dict[int, Dict[str, np.ndarray]] = {
            0: self.final_pred
        }
        self.labels = None if labels is None else to_numpy(labels)
        self.n_samples = int(next(iter(self.final_pred.values())).shape[0])

    def gate(self, sample: int, branch: int, p_tar: float, t: float = 0.0):
        """-> (on_device, prediction, confidence, true_ctx, est_ctx);
        est_ctx is None unless a real estimator produced it (oracle-mode
        selection must not masquerade as a perfect estimator in
        telemetry's est_match_rate)."""
        ctx = self.schedule.context_at(t)
        pk = self._est[ctx][sample]
        conf = self.conf[(ctx, pk, branch)][sample]
        pred = int(self.pred[(ctx, pk, branch)][sample])
        est = None if self._oracle else pk
        return bool(conf >= p_tar), pred, float(conf), ctx, est

    def cloud_predict(self, sample: int, branch: int,
                      context: Optional[str] = None, level: int = 0) -> int:
        """Main-head prediction for an offloaded sample. `level` is the
        codec level the payload shipped at: non-zero levels round-trip the
        stored final logits through the codec on the backend's device
        once per (level, context) -- the same accuracy-delta model the
        controller priced at fit time. Level 0 is the untouched legacy
        table."""
        ctx = self.ctx_keys[0] if context is None else context
        level = int(level)
        if level not in self._final_pred_by_level:
            dev = self.backend.device
            self._final_pred_by_level[level] = {
                c: np.argmax(to_numpy(roundtrip(z, level, device=dev)), axis=-1)
                for c, z in self._final_logits.items()
            }
        return int(self._final_pred_by_level[level][ctx][sample])

    def correct(self, sample: int, prediction: int) -> Optional[bool]:
        if self.labels is None:
            return None
        return bool(prediction == self.labels[sample])
