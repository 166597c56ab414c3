"""Post-hoc calibration (paper Sec. IV-A, following Guo et al. 2017).

Port of `repro.core.calibration`. Two layers of API:

1. Fit primitives (`fit_temperature`, `fit_vector_scaling`,
   `calibrate_cascade`) -- deterministic optimizers over validation
   logits, run on the logits' device.

2. The `Calibrator` protocol -- a calibrator turns a validation pass into
   a `CalibratorState` (a kind name plus float32 tensors) and maps raw
   logits to calibrated logits at inference time:

       state  = get_calibrator("temperature").fit(logits, labels)
       logits = apply_calibrator(state, logits)

   Implementations are looked up by name in a registry: ``temperature``
   (the paper's method, Eq. 2), ``vector`` (per-class affine), and
   ``identity`` (the conventional-DNN baseline, T=1). States serialize to
   the same plain dicts as the reference (`CalibratorState.to_dict` /
   `from_dict`), so a plan JSON written by either package loads in the
   other. A state's tensors live on the CPU; `apply` moves what it needs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch._device import as_tensor


def _weighted_mean(x, weights):
    if weights is None:
        return torch.mean(x)
    w = weights.to(torch.float32)
    return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1e-9)


def nll(logits, labels, temperature, weights=None):
    """Mean negative log-likelihood of softmax(logits/T).

    weights: optional per-sample non-negative weights; None = uniform.
    """
    z = logits.to(torch.float32) / temperature
    logp = torch.log_softmax(z, dim=-1)
    per_sample = -torch.gather(logp, -1, labels.to(torch.int64)[:, None])[:, 0]
    return _weighted_mean(per_sample, weights)


def _nll_logt_derivatives(z, labels, logt, weights):
    """First and second derivative of the (weighted) mean NLL in log T,
    in closed form. With u = z/T, p = softmax(u), E = E_p[z] and
    V = Var_p[z], per sample:
        d nll / d log T   = (z_y - E) / T
        d2 nll / d log T2 = -(z_y - E) / T + V / T^2
    """
    t = torch.exp(logt)
    p = torch.softmax(z / t, dim=-1)
    e = torch.sum(p * z, dim=-1)
    v = torch.sum(p * (z - e[:, None]) ** 2, dim=-1)
    zy = torch.gather(z, -1, labels[:, None])[:, 0]
    r = (zy - e) / t
    return _weighted_mean(r, weights), _weighted_mean(-r + v / (t * t), weights)


def fit_temperature(
    logits,
    labels,
    t_min: float = 0.05,
    t_max: float = 20.0,
    newton_steps: int = 30,
    weights=None,
) -> Tuple[torch.Tensor, dict]:
    """Fit T by NLL minimization over log-T (convex in practice).

    Newton's method on log T (step clipped to +-1, log T clipped to
    [log t_min, log t_max]) with the derivatives in CLOSED FORM (see
    `_nll_logt_derivatives`; no autograd), then the reference's
    golden-section fallback over the whole range, keeping whichever point
    has the lower NLL. The plain torch path is right here: the reference
    fitter never reaches a Pallas kernel either (the fused K2 Newton fit
    is `kernels.ops.fit_temperature_kernel`).

    weights: optional per-sample weights (sequential cascade calibration
    restricts the fit to the samples that reach the exit). Returns
    (T as a 0-d float32 tensor on the logits' device, info).
    """
    z = as_tensor(logits).to(torch.float32)
    y = as_tensor(labels, z.device).to(device=z.device, dtype=torch.int64)
    if weights is not None:
        weights = as_tensor(weights, z.device).to(device=z.device, dtype=torch.float32)
    lo_bound = torch.tensor(math.log(t_min), dtype=torch.float32, device=z.device)
    hi_bound = torch.tensor(math.log(t_max), dtype=torch.float32, device=z.device)

    def loss_logt(logt):
        return nll(z, y, torch.exp(logt), weights=weights)

    logt = torch.zeros((), dtype=torch.float32, device=z.device)
    steps = []
    for _ in range(newton_steps):
        grad, hess = _nll_logt_derivatives(z, y, logt, weights)
        step = torch.where(hess.abs() > 1e-8, grad / hess, torch.sign(grad) * 0.1)
        step = torch.clamp(step, -1.0, 1.0)
        logt = torch.minimum(torch.maximum(logt - step, lo_bound), hi_bound)
        steps.append(step.abs())
    T = torch.exp(logt)

    # golden-section fallback if Newton walked to the boundary
    phi = 0.6180339887498949
    lo, hi = lo_bound, hi_bound
    for _ in range(60):
        m1 = hi - phi * (hi - lo)
        m2 = lo + phi * (hi - lo)
        left = loss_logt(m1) < loss_logt(m2)
        lo = torch.where(left, lo, m1)
        hi = torch.where(left, m2, hi)
    logt_g = (lo + hi) / 2
    T_g = torch.exp(logt_g)
    T_final = torch.where(loss_logt(torch.log(T)) <= loss_logt(logt_g), T, T_g)
    info = {
        "nll_before": nll(z, y, 1.0, weights=weights),
        "nll_after": nll(z, y, T_final, weights=weights),
        "converged_step": torch.min(torch.stack(steps)),
    }
    return T_final, info


def fit_vector_scaling(logits, labels, steps: int = 200, lr: float = 0.05):
    """Beyond-paper: per-class affine calibration p = softmax(w*z + b).

    Gradient descent on NLL (autograd); returns (w, b, info).
    """
    z = as_tensor(logits).detach().to(torch.float32)
    y = as_tensor(labels, z.device).to(device=z.device, dtype=torch.int64)
    k = z.shape[-1]

    def loss(w, b):
        logp = torch.log_softmax(z * w + b, dim=-1)
        return -torch.mean(torch.gather(logp, -1, y[:, None]))

    with torch.enable_grad():
        w = torch.ones(k, device=z.device, requires_grad=True)
        b = torch.zeros(k, device=z.device, requires_grad=True)
        for _ in range(steps):
            gw, gb = torch.autograd.grad(loss(w, b), (w, b))
            with torch.no_grad():
                w -= lr * gw
                b -= lr * gb
    w, b = w.detach(), b.detach()
    with torch.no_grad():
        ones = torch.ones(k, device=z.device)
        info = {"nll_before": loss(ones, torch.zeros_like(ones)), "nll_after": loss(w, b)}
    return w, b, info


def calibrate_cascade(exit_logits_list, labels, sequential: bool = False, p_tar: float = 0.8):
    """Fit one temperature per exit.

    sequential=False (paper / Guo): each exit fit on ALL validation samples.
    sequential=True (beyond-paper): exit i is fit only on the samples that
    reach it under the already-calibrated earlier exits; reachability
    enters the fit as per-sample NLL weights.
    """
    from repro_torch.core.exits import gate_statistics

    temps = []
    reach = None
    for logits in exit_logits_list:
        logits = as_tensor(logits)
        if reach is None:
            reach = torch.ones(logits.shape[0], dtype=torch.bool, device=logits.device)
        if sequential and not bool(torch.all(reach)):
            T, _ = fit_temperature(logits, labels, weights=reach.to(torch.float32))
        else:
            T, _ = fit_temperature(logits, labels)
        temps.append(float(T))
        if sequential:
            conf, _, _ = gate_statistics(logits, temps[-1])
            reach = reach & (conf < p_tar)
    return temps


# --------------------------------------------------------------------------
# Calibrator protocol: fit -> CalibratorState -> apply
# --------------------------------------------------------------------------
@dataclass
class CalibratorState:
    """The deployable output of a calibration pass for ONE exit: the
    calibrator's registry `kind` and its float32 `params` (CPU tensors)."""

    kind: str
    params: Dict[str, torch.Tensor]

    # -- serialization (JSON-safe plain dicts; float32 round-trips exactly
    #    through Python floats, so reloaded states gate bit-identically)
    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "params": {
                k: np.asarray(v.detach().cpu().numpy(), np.float32).tolist()
                for k, v in self.params.items()
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CalibratorState":
        return cls(
            kind=d["kind"],
            params={k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in d["params"].items()},
        )

    @property
    def temperature(self) -> Optional[float]:
        """Effective scalar temperature, or None if not expressible as one."""
        if self.kind == "temperature":
            return float(self.params["temperature"])
        if self.kind == "identity":
            return 1.0
        return None


@runtime_checkable
class Calibrator(Protocol):
    """A named calibration method: fit on validation logits, apply at serve."""

    name: str

    def fit(self, logits, labels, **kwargs) -> CalibratorState: ...

    def apply(self, state: CalibratorState, logits) -> torch.Tensor: ...


_CALIBRATORS: Dict[str, Calibrator] = {}


def register_calibrator(calibrator: Calibrator) -> Calibrator:
    """Register (an instance of) a Calibrator under its `name`."""
    _CALIBRATORS[calibrator.name] = calibrator
    return calibrator


def get_calibrator(name: str) -> Calibrator:
    try:
        return _CALIBRATORS[name]
    except KeyError:
        raise KeyError(
            f"unknown calibrator {name!r}; registered: {sorted(_CALIBRATORS)}"
        ) from None


def available_calibrators():
    return sorted(_CALIBRATORS)


def apply_calibrator(state: CalibratorState, logits) -> torch.Tensor:
    """Dispatch `apply` through the registry on the state's kind."""
    return get_calibrator(state.kind).apply(state, as_tensor(logits))


def _scalar_state(kind: str, t: float) -> CalibratorState:
    return CalibratorState(kind, {"temperature": torch.tensor(float(t), dtype=torch.float32)})


class TemperatureScaling:
    """The paper's method (Guo et al. Eq. 2): z -> z / T."""

    name = "temperature"

    def fit(self, logits, labels, weights=None, **kwargs) -> CalibratorState:
        T, _ = fit_temperature(logits, labels, weights=weights, **kwargs)
        return _scalar_state(self.name, float(T))

    def apply(self, state, logits):
        # a 0-d CPU tensor combines with a CUDA tensor without a copy
        return logits.to(torch.float32) / state.params["temperature"]

    @staticmethod
    def from_temperature(t: float) -> CalibratorState:
        return _scalar_state("temperature", t)


class VectorScaling:
    """Beyond-paper per-class affine: z -> w * z + b."""

    name = "vector"

    def fit(self, logits, labels, **kwargs) -> CalibratorState:
        w, b, _ = fit_vector_scaling(logits, labels, **kwargs)
        return CalibratorState(self.name, {"w": w.cpu(), "b": b.cpu()})

    def apply(self, state, logits):
        w = state.params["w"].to(logits.device)
        b = state.params["b"].to(logits.device)
        return logits.to(torch.float32) * w + b


class Identity:
    """The conventional-DNN baseline: no calibration (T=1 everywhere)."""

    name = "identity"

    def fit(self, logits, labels, **kwargs) -> CalibratorState:
        return CalibratorState(self.name, {})

    def apply(self, state, logits):
        return logits


register_calibrator(TemperatureScaling())
register_calibrator(VectorScaling())
register_calibrator(Identity())
