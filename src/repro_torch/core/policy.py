"""OffloadPlan: the single deployable artifact of a calibration pass.

Port of `repro.core.policy`. A plan bundles the paper's three coupled
decisions -- one `CalibratorState` per early exit, the gating criterion
and `p_tar`, and the deployed exit / partition layer -- and serializes to
the reference's JSON schema (`PLAN_FORMAT_VERSION = 1`): a plan saved by
`repro` loads here and saves back to the identical string, and the other
way round. Consumed by `repro_torch.offload.engine`,
`repro_torch.core.partition`, `repro_torch.core.exits.cascade_gate`,
`repro_torch.core.gatepath` (`gate_block`) and `repro_torch.core.control`
(`rescore_plan`, re-exported here as in the reference). The deprecated
`OffloadPolicy` / `make_policy` shims of the seed API are kept, as in the
reference.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from repro_torch._device import as_tensor
from repro_torch.core.calibration import (
    CalibratorState,
    TemperatureScaling,
    apply_calibrator,
    calibrate_cascade,
    get_calibrator,
)
from repro_torch.core.exits import apply_gate

PLAN_FORMAT_VERSION = 1


@dataclass
class OffloadPlan:
    p_tar: float
    calibrators: List[CalibratorState]  # one per exit, shallowest first
    criterion: str = "confidence"  # confidence | entropy
    entropy_threshold: Optional[float] = None
    exit_index: int = 0  # deployed exit: which calibrator single-branch paths use
    partition_layer: Optional[int] = None  # model layer of the split, if chosen
    compression_level: int = 0  # payload codec level (0 = raw float32)
    metadata: Dict[str, Any] = field(default_factory=dict)

    @property
    def num_exits(self) -> int:
        return len(self.calibrators)

    @property
    def temperatures(self) -> List[float]:
        """Legacy temperature-list view (1.0 for states with no scalar T)."""
        return [s.temperature if s.temperature is not None else 1.0
                for s in self.calibrators]

    # ------------------------------------------------------------- gating
    def _state_for(self, branch: Optional[int]) -> CalibratorState:
        branch = self.exit_index if branch is None else branch
        if not 0 <= branch < self.num_exits:
            raise ValueError(
                f"exit {branch} has no calibrator state "
                f"(plan covers {self.num_exits} exit(s))"
            )
        return self.calibrators[branch]

    def calibrated_logits(self, exit_logits, branch: Optional[int] = None):
        return apply_calibrator(self._state_for(branch), exit_logits)

    def gate(self, exit_logits, branch: Optional[int] = None, use_kernel: bool = False):
        """Gate one exit's logits under this plan's calibrator + criterion.

        When the branch's calibration is a scalar temperature (temperature
        scaling or identity), the raw logits and T go straight to the gate
        (on the card, the fused K1 kernel) without materializing
        calibrated logits. Richer calibrators apply first and gate at T=1.
        """
        state = self._state_for(branch)
        if state.kind in ("temperature", "identity"):
            return apply_gate(
                exit_logits,
                self.p_tar,
                temperature=state.temperature,
                criterion=self.criterion,
                entropy_threshold=self.entropy_threshold,
                use_kernel=use_kernel,
            )
        return apply_gate(
            apply_calibrator(state, exit_logits),
            self.p_tar,
            temperature=1.0,
            criterion=self.criterion,
            entropy_threshold=self.entropy_threshold,
            use_kernel=use_kernel,
        )

    def gate_block(self, exit_logits, branch: Optional[int] = None,
                   backend=None):
        """Batched gate statistics for a whole logit block -> numpy
        (confidence float64, prediction int64) of shape (N,).

        Same math as `gate`, returned as host arrays ready for vectorized
        thresholding `conf >= p_tar` over the whole block. `backend`
        selects the execution path (`core.gatepath`): None -> ``"torch"``
        (one K1 launch on the card); ``"numpy"`` -> the host spec.
        """
        from repro_torch.core.gatepath import get_gate_backend

        return get_gate_backend(backend).plan_gate_block(
            self, exit_logits, branch=branch
        )

    def _copy(self, **overrides) -> "OffloadPlan":
        """Fresh OffloadPlan (never the OffloadPolicy shim subclass) with
        mutable fields copied -- the single place plan fields are threaded
        through."""
        kw = dict(
            p_tar=self.p_tar,
            calibrators=list(self.calibrators),
            criterion=self.criterion,
            entropy_threshold=self.entropy_threshold,
            exit_index=self.exit_index,
            partition_layer=self.partition_layer,
            compression_level=self.compression_level,
            metadata=dict(self.metadata),
        )
        kw.update(overrides)
        return OffloadPlan(**kw)

    def with_partition(self, exit_index: int, partition_layer: int) -> "OffloadPlan":
        """New plan with the chosen partition point recorded."""
        return self._copy(exit_index=exit_index, partition_layer=partition_layer)

    def with_p_tar(self, p_tar: float) -> "OffloadPlan":
        """New plan with a different effective reliability target (the
        calibrators are untouched)."""
        return self._copy(p_tar=float(p_tar))

    def with_compression(self, level: int) -> "OffloadPlan":
        """New plan with a different payload codec level (see
        `repro_torch.kernels.compress.LEVELS`; 0 ships the raw float32
        activation, the paper's pricing)."""
        return self._copy(compression_level=int(level))

    # ------------------------------------------------------ serialization
    def to_dict(self) -> dict:
        return {
            "version": PLAN_FORMAT_VERSION,
            "p_tar": float(self.p_tar),
            "calibrators": [s.to_dict() for s in self.calibrators],
            "criterion": self.criterion,
            "entropy_threshold": (
                None if self.entropy_threshold is None else float(self.entropy_threshold)
            ),
            "exit_index": int(self.exit_index),
            "partition_layer": (
                None if self.partition_layer is None else int(self.partition_layer)
            ),
            "compression_level": int(self.compression_level),
            "metadata": self.metadata,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "OffloadPlan":
        version = d.get("version", PLAN_FORMAT_VERSION)
        if version > PLAN_FORMAT_VERSION:
            raise ValueError(f"plan format v{version} is newer than supported "
                             f"v{PLAN_FORMAT_VERSION}")
        return cls(
            p_tar=d["p_tar"],
            calibrators=[CalibratorState.from_dict(s) for s in d["calibrators"]],
            criterion=d.get("criterion", "confidence"),
            entropy_threshold=d.get("entropy_threshold"),
            exit_index=d.get("exit_index", 0),
            partition_layer=d.get("partition_layer"),
            compression_level=d.get("compression_level", 0),
            metadata=d.get("metadata", {}),
        )

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, **kwargs)

    @classmethod
    def from_json(cls, s: str) -> "OffloadPlan":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2))

    @classmethod
    def load(cls, path: str) -> "OffloadPlan":
        with open(path) as f:
            return cls.from_json(f.read())


def make_plan(
    exit_logits_list,
    labels,
    p_tar: float,
    method: str = "temperature",
    calibrated: bool = True,
    sequential: bool = False,
    criterion: str = "confidence",
    entropy_threshold: Optional[float] = None,
    exit_index: int = 0,
    metadata: Optional[Dict[str, Any]] = None,
    device=None,
) -> OffloadPlan:
    """Build a deployable plan from a validation pass.

    calibrated=False reproduces the paper's 'conventional DNN' baseline
    (identity calibration, T=1 everywhere); otherwise `method` picks the
    registered calibrator fit per exit. sequential=True (temperature only)
    fits exit i on the samples that reach it in the cascade. Logits and
    labels that are not tensors land on `device` (``cuda`` by default).
    """
    exit_logits_list = [as_tensor(z, device) for z in exit_logits_list]
    labels = as_tensor(labels, device)
    if not calibrated:
        method = "identity"
    cal = get_calibrator(method)
    if method == "temperature":
        temps = calibrate_cascade(
            exit_logits_list, labels, sequential=sequential, p_tar=p_tar
        )
        states = [TemperatureScaling.from_temperature(t) for t in temps]
    else:
        states = [cal.fit(z, labels) for z in exit_logits_list]
    return OffloadPlan(
        p_tar=p_tar,
        calibrators=states,
        criterion=criterion,
        entropy_threshold=entropy_threshold,
        exit_index=exit_index,
        metadata=metadata or {},
    )


# ----------------------------------------------------- online re-scoring
# rescore_plan lives in `repro_torch.core.control` (the shared controller
# core); this import keeps `repro_torch.core.policy.rescore_plan` working,
# as in the reference. It sits below the class definitions so the control
# module can be imported first without a cycle.
from repro_torch.core.control import rescore_plan  # noqa: E402,F401


# ------------------------------------------------------- deprecation shims
class OffloadPolicy(OffloadPlan):
    """Deprecated temperature-list constructor; use OffloadPlan/make_plan."""

    def __init__(
        self,
        p_tar: float,
        temperatures: Sequence[float],
        criterion: str = "confidence",
        entropy_threshold: Optional[float] = None,
        exit_index: int = 0,
        calibrated: bool = True,
    ):
        OffloadPlan.__init__(
            self,
            p_tar=p_tar,
            calibrators=[TemperatureScaling.from_temperature(t) for t in temperatures],
            criterion=criterion,
            entropy_threshold=entropy_threshold,
            exit_index=exit_index,
            metadata={"calibrated": calibrated},
        )
        self.calibrated = calibrated


def make_policy(
    exit_logits_list,
    labels,
    p_tar: float,
    calibrated: bool = True,
    sequential: bool = False,
    device=None,
) -> OffloadPlan:
    """Deprecated: thin wrapper over make_plan (kept for the seed API).
    Logits and labels that are not tensors land on `device` (``cuda`` by
    default)."""
    return make_plan(
        exit_logits_list,
        labels,
        p_tar=p_tar,
        calibrated=calibrated,
        sequential=sequential,
        device=device,
    )
