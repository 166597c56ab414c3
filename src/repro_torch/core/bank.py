"""Expert calibration banks: one OffloadPlan per input-distortion context.

The paper fits one set of branch temperatures on clean validation data.
Pacheco et al. (2108.09343) show that gate breaks under blur/noise: the
side branch stays confident while its accuracy collapses, so the single
global calibrator silently misses `p_tar`. The fix is a bank of *expert*
plans -- one `OffloadPlan` fit per distortion context -- plus a cheap
edge-side estimator that recognizes the current context from input
statistics and picks the matching expert.

Two pieces, both JSON-serializable so the whole bank ships as one artifact:

* `DistortionEstimator` -- nearest-centroid classifier over the per-image
  statistics of `repro_torch.data.distortion.input_features` (Laplacian variance
  + pixel moments + total variation). Features are z-scored with the
  fit-pool moments; no DNN, no gradient, ~10 flops per feature at serve
  time. It is domain-agnostic: any (N, F) feature matrix works.

* `PlanBank` -- {context key: OffloadPlan} with a designated default
  context (the fallback for unrecognized conditions), an optional embedded
  estimator, and the same versioned JSON round-trip contract as
  `OffloadPlan` (a reloaded bank gates bit-identically per context).

`fit_bank` builds both from per-context validation logits in one call.

Port of `repro.core.bank`: the estimator and the bank are host numpy and
JSON, so a bank written by either package loads in the other; the expert
fits (`make_plan`), the frozen fit-time ECE and `PlanBank.gate_block` run
on the port's device (K1 on the card).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch._device import as_tensor, to_numpy
from repro_torch.core.policy import OffloadPlan, make_plan

BANK_FORMAT_VERSION = 1

#: The estimator's verdict when the input matches no fitted context: never a
#: real context key, and `PlanBank.plan_for` resolves it to the default plan.
UNKNOWN_CONTEXT = "__unknown__"


# ---------------------------------------------------- distortion estimator
@dataclass
class DistortionEstimator:
    """Nearest-centroid context classifier over cheap input statistics.

    Fit: pool every context's features, z-score with the pooled mean/std,
    store one normalized centroid per context. Predict: normalize, return
    the context whose centroid is nearest in L2 -- per batch (`predict`,
    the serving path: one decision per microbatch of inputs) or per sample
    (`predict_per_sample` / `predict_ids`, what the drift simulators
    precompute).

    Unknown verdict (estimator robustness under inputs the bank was never
    fit for, e.g. composed distortions like noise+blur): with
    ``unknown_distance`` set, an input whose nearest-centroid distance
    exceeds it is off-manifold; with ``unknown_margin`` set, an input whose
    two nearest centroids are closer than the margin is ambiguous between
    experts. Either way the verdict is `UNKNOWN_CONTEXT`, which a `PlanBank`
    resolves to its DEFAULT plan -- falling back to the broadest calibrator
    instead of gating with the nearest *wrong* expert. Distances live in the
    z-scored feature space; batch-mean distances (`predict`) concentrate
    much tighter than per-sample ones (`predict_per_sample`), so thresholds
    are calibrated for whichever path consumes them. Both default to None
    (verdicts never unknown, the pre-existing behavior).
    """

    contexts: List[str]
    centroids: np.ndarray  # (K, F), z-scored feature space
    norm_mean: np.ndarray  # (F,)
    norm_std: np.ndarray  # (F,)
    feature_names: Optional[Tuple[str, ...]] = None
    unknown_distance: Optional[float] = None  # d1 above this -> unknown
    unknown_margin: Optional[float] = None  # d2 - d1 below this -> unknown

    @classmethod
    def fit(
        cls,
        features_by_context: Dict[str, np.ndarray],
        feature_names: Optional[Sequence[str]] = None,
        unknown_distance: Optional[float] = None,
        unknown_margin: Optional[float] = None,
    ) -> "DistortionEstimator":
        if not features_by_context:
            raise ValueError("need at least one context to fit")
        keys = sorted(features_by_context)
        feats = {k: np.asarray(features_by_context[k], np.float64) for k in keys}
        pool = np.concatenate([feats[k] for k in keys], axis=0)
        mean = pool.mean(axis=0)
        std = np.maximum(pool.std(axis=0), 1e-9)
        centroids = np.stack(
            [((feats[k] - mean) / std).mean(axis=0) for k in keys]
        )
        return cls(
            contexts=list(keys),
            centroids=centroids,
            norm_mean=mean,
            norm_std=std,
            feature_names=None if feature_names is None else tuple(feature_names),
            unknown_distance=unknown_distance,
            unknown_margin=unknown_margin,
        )

    def _distances(self, features: np.ndarray) -> np.ndarray:
        f = np.asarray(features, np.float64)
        if f.ndim == 1:
            f = f[None, :]
        z = (f - self.norm_mean) / self.norm_std
        return np.linalg.norm(z[:, None, :] - self.centroids[None, :, :], axis=-1)

    def _ids_from_distances(self, d: np.ndarray) -> np.ndarray:
        """Nearest-centroid index per row, -1 where the unknown verdict
        fires (distance cap exceeded, or nearest-vs-second margin too thin
        to trust with fewer than two contexts the margin rule is moot)."""
        idx = np.argmin(d, axis=1).astype(np.int64)
        if self.unknown_distance is not None or self.unknown_margin is not None:
            part = np.sort(d, axis=1)
            unknown = np.zeros(len(d), bool)
            if self.unknown_distance is not None:
                unknown |= part[:, 0] > self.unknown_distance
            if self.unknown_margin is not None and d.shape[1] > 1:
                unknown |= (part[:, 1] - part[:, 0]) < self.unknown_margin
            idx[unknown] = -1
        return idx

    def predict(self, features: np.ndarray) -> str:
        """One context for a whole batch: classify the batch-mean feature
        vector (the per-batch selection rule of the serving path)."""
        f = np.asarray(features, np.float64)
        batch_mean = f if f.ndim == 1 else f.mean(axis=0)
        i = int(self._ids_from_distances(self._distances(batch_mean))[0])
        return UNKNOWN_CONTEXT if i < 0 else self.contexts[i]

    def predict_ids(self, features: np.ndarray) -> np.ndarray:
        """Vectorized per-sample verdicts as indices into `contexts`
        (-1 = unknown) -- the batched path the fleet simulator consumes."""
        return self._ids_from_distances(self._distances(features))

    def predict_per_sample(self, features: np.ndarray) -> List[str]:
        return [
            UNKNOWN_CONTEXT if i < 0 else self.contexts[i]
            for i in self.predict_ids(features)
        ]

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {
            "contexts": list(self.contexts),
            "centroids": self.centroids.tolist(),
            "norm_mean": self.norm_mean.tolist(),
            "norm_std": self.norm_std.tolist(),
            "feature_names": (
                None if self.feature_names is None else list(self.feature_names)
            ),
            "unknown_distance": (
                None if self.unknown_distance is None else float(self.unknown_distance)
            ),
            "unknown_margin": (
                None if self.unknown_margin is None else float(self.unknown_margin)
            ),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DistortionEstimator":
        names = d.get("feature_names")
        return cls(
            contexts=list(d["contexts"]),
            centroids=np.asarray(d["centroids"], np.float64),
            norm_mean=np.asarray(d["norm_mean"], np.float64),
            norm_std=np.asarray(d["norm_std"], np.float64),
            feature_names=None if names is None else tuple(names),
            unknown_distance=d.get("unknown_distance"),
            unknown_margin=d.get("unknown_margin"),
        )


# --------------------------------------------------------------- plan bank
@dataclass
class PlanBank:
    """{context key: expert OffloadPlan} + fallback + optional estimator.

    The bank is the drifting-conditions analogue of a single plan: the lab
    fits one expert per expected input regime, serializes the whole bank,
    and the edge device picks `plan_for(estimated context)` per batch.
    Context keys are free-form strings; `data.distortion` uses
    `DistortionSpec.key` (``"gaussian_noise@3"``, ``"clean"``).
    """

    plans: Dict[str, OffloadPlan]
    default_context: str
    estimator: Optional[DistortionEstimator] = None
    metadata: Dict[str, Any] = field(default_factory=dict)
    #: Monotonic deployment version (the reference's orchestration rollout
    #: bumps it per candidate): which bank GENERATION this is, as opposed to
    #: `schema_version`, which says how the JSON is laid out. Old files
    #: without the field load as generation 0.
    bank_version: int = 0

    def __post_init__(self):
        if not self.plans:
            raise ValueError("PlanBank needs at least one plan")
        if self.default_context not in self.plans:
            raise ValueError(
                f"default context {self.default_context!r} has no plan "
                f"(bank covers {self.contexts})"
            )
        if self.estimator is not None:
            unknown = set(self.estimator.contexts) - set(self.plans)
            if unknown:
                raise ValueError(
                    f"estimator may predict contexts with no expert plan: "
                    f"{sorted(unknown)}"
                )

    @property
    def contexts(self) -> List[str]:
        return sorted(self.plans)

    @property
    def default_plan(self) -> OffloadPlan:
        return self.plans[self.default_context]

    @property
    def compression_level(self) -> int:
        """Codec level of the DEFAULT plan -- what the serving layers
        price uplink payloads at (experts share the wire format, only
        their calibrators differ)."""
        return int(getattr(self.default_plan, "compression_level", 0))

    def with_compression(self, level: int) -> "PlanBank":
        """New bank with every expert's payload codec set to `level`
        (see `OffloadPlan.with_compression`): distortion-driven expert
        selection and the wire format compose without touching each
        other's state."""
        return replace(
            self,
            plans={c: p.with_compression(level)
                   for c, p in self.plans.items()},
        )

    def plan_for(self, context: Optional[str]) -> OffloadPlan:
        """The expert for `context`, or the default plan for unknown/None
        contexts (an edge device must never be left without a gate)."""
        if context is None:
            return self.default_plan
        return self.plans.get(context, self.default_plan)

    def select(self, features: np.ndarray) -> Tuple[str, OffloadPlan]:
        """Estimate the context of an input batch's features and return
        (context, expert plan) -- the per-batch edge-side decision. An
        `UNKNOWN_CONTEXT` verdict (estimator's distance/margin rule fired)
        resolves to the default plan, never to the nearest wrong expert."""
        if self.estimator is None:
            raise ValueError("this bank has no embedded estimator")
        ctx = self.estimator.predict(features)
        return ctx, self.plan_for(ctx)

    def gate_block(
        self,
        exit_logits: np.ndarray,
        features: Optional[np.ndarray] = None,
        branch: Optional[int] = None,
        expert_ids: Optional[np.ndarray] = None,
        backend=None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched per-sample expert gating over a whole logit block.

        -> (confidence, prediction, expert_ids): each sample's confidence
        and argmax under the calibrator of ITS expert plan, where experts
        come from `expert_ids` (indices into ``self.contexts``, -1 =
        unknown -> default plan) or, if omitted, from the embedded
        estimator on `features`. `backend` selects the execution path
        (`core.gatepath`): the default ``"torch"`` backend gathers
        per-sample expert temperatures on the device (an expert with a
        richer calibrator applies it to its rows there) and evaluates the
        whole block in one K1 launch; the host ``"numpy"`` backend makes
        one call per DISTINCT expert in the block.
        """
        from repro_torch.core.gatepath import get_gate_backend

        z = exit_logits
        if expert_ids is None:
            if features is None:
                raise ValueError("need features or expert_ids to pick experts")
            if self.estimator is None:
                raise ValueError("this bank has no embedded estimator")
            expert_ids = self.estimator.predict_ids(features)
        expert_ids = np.asarray(expert_ids, np.int64)
        if expert_ids.shape[0] != len(z):
            raise ValueError(
                f"expert_ids covers {expert_ids.shape[0]} samples but the "
                f"logit block has {len(z)}"
            )
        conf, pred = get_gate_backend(backend).bank_gate_block(
            self, z, expert_ids, branch=branch
        )
        return conf, pred, expert_ids

    def bumped(self, bank_version: Optional[int] = None) -> "PlanBank":
        """A copy at the next (or the given) deployment version -- what a
        rollout manager registers as the candidate generation. Plans and
        estimator are shared, not copied: a version bump is bookkeeping."""
        v = self.bank_version + 1 if bank_version is None else int(bank_version)
        if v <= self.bank_version:
            raise ValueError(
                f"bank_version must increase (have {self.bank_version}, "
                f"got {v})"
            )
        return PlanBank(
            plans=self.plans,
            default_context=self.default_context,
            estimator=self.estimator,
            metadata=dict(self.metadata),
            bank_version=v,
        )

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {
            # "version" is the legacy spelling of the schema version; both
            # keys are written so pre-orchestration readers keep loading
            # new files (the schema only ever ADDED optional fields)
            "version": BANK_FORMAT_VERSION,
            "schema_version": BANK_FORMAT_VERSION,
            "bank_version": int(self.bank_version),
            "default_context": self.default_context,
            "plans": {k: p.to_dict() for k, p in self.plans.items()},
            "estimator": None if self.estimator is None else self.estimator.to_dict(),
            "metadata": self.metadata,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PlanBank":
        # "version" is the legacy spelling of schema_version; a file
        # declaring a too-new layout under EITHER key is refused
        declared = [d[k] for k in ("schema_version", "version") if k in d]
        version = max(declared) if declared else BANK_FORMAT_VERSION
        if version > BANK_FORMAT_VERSION:
            raise ValueError(
                f"bank format v{version} is newer than supported "
                f"v{BANK_FORMAT_VERSION}"
            )
        est = d.get("estimator")
        return cls(
            plans={k: OffloadPlan.from_dict(p) for k, p in d["plans"].items()},
            default_context=d["default_context"],
            estimator=None if est is None else DistortionEstimator.from_dict(est),
            metadata=d.get("metadata", {}),
            bank_version=int(d.get("bank_version", 0)),
        )

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, **kwargs)

    @classmethod
    def from_json(cls, s: str) -> "PlanBank":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2))

    @classmethod
    def load(cls, path: str) -> "PlanBank":
        with open(path) as f:
            return cls.from_json(f.read())


def fit_bank(
    exit_logits_by_context: Dict[str, Sequence],
    labels,
    p_tar: float,
    default_context: str = "clean",
    features_by_context: Optional[Dict[str, np.ndarray]] = None,
    labels_by_context: Optional[Dict[str, Any]] = None,
    metadata: Optional[Dict[str, Any]] = None,
    estimator_kwargs: Optional[Dict[str, Any]] = None,
    device=None,
    **make_plan_kwargs,
) -> PlanBank:
    """Fit one expert OffloadPlan per context + (optionally) the estimator.

    exit_logits_by_context: {context: [exit1_logits, exit2_logits, ...]}
    from a validation pass over that context's distorted inputs. `labels`
    is shared across contexts (the usual case: the SAME validation images
    distorted per context); `labels_by_context` overrides per context.
    `features_by_context` ({context: (N, F)} from `input_features` on the
    distorted validation images) additionally fits the embedded
    `DistortionEstimator`; `estimator_kwargs` forwards its extra fit
    options (e.g. ``unknown_distance`` / ``unknown_margin``). Extra kwargs
    go to `make_plan` (method, criterion, sequential, ...). Logits that are
    not tensors land on `device` (``cuda`` by default) for the fits and
    the gate.
    """
    if default_context not in exit_logits_by_context:
        raise ValueError(
            f"default context {default_context!r} not among fitted contexts "
            f"{sorted(exit_logits_by_context)}"
        )
    from repro_torch.core.exits import gate_statistics
    from repro_torch.core.metrics import ece as _ece

    plans = {}
    fit_ece: Dict[str, Dict[str, float]] = {}
    for ctx in sorted(exit_logits_by_context):
        y = labels if labels_by_context is None else labels_by_context[ctx]
        zs = [as_tensor(z, device) for z in exit_logits_by_context[ctx]]
        plans[ctx] = make_plan(zs, y, p_tar=p_tar, device=device, **make_plan_kwargs)
        # fit-time calibration health, frozen into the artifact: the val
        # ECE each expert shipped with, per branch. The deployed-side
        # drift report (the reference's obs.calibration_report) diffs the windowed
        # serving ECE against these to flag regimes that drifted.
        yv = to_numpy(y)
        per_branch: Dict[str, float] = {}
        for bi, z in enumerate(zs):
            conf, pred, _ = gate_statistics(
                plans[ctx].calibrated_logits(z, bi)
            )
            per_branch[str(bi + 1)] = float(
                _ece(to_numpy(conf).astype(np.float64),
                     (to_numpy(pred) == yv).astype(np.float64))
            )
        fit_ece[ctx] = per_branch
    estimator = None
    if features_by_context is not None:
        missing = set(features_by_context) - set(plans)
        if missing:
            raise ValueError(
                f"features provided for contexts with no logits: {sorted(missing)}"
            )
        from repro_torch.data.distortion import FEATURE_NAMES

        names = FEATURE_NAMES if all(
            np.asarray(f).shape[-1] == len(FEATURE_NAMES)
            for f in features_by_context.values()
        ) else None
        estimator = DistortionEstimator.fit(
            features_by_context, feature_names=names, **(estimator_kwargs or {})
        )
    meta = dict(metadata or {})
    meta.setdefault("fit_ece", fit_ece)
    return PlanBank(
        plans=plans,
        default_context=default_context,
        estimator=estimator,
        metadata=meta,
    )
