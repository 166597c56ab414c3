"""Early-exit confidence gating (paper Sec. III).

Port of `repro.core.exits`. Given side-branch logits z_i, the gate
computes the calibrated probability vector p_i = softmax(z_i / T) and
classifies on-device iff max p_i >= p_tar. An entropy criterion
(BranchyNet's original rule) is also provided.

Every gate statistic goes through `kernels.ops.exit_gate`: on a CUDA
tensor that is ALWAYS the fused K1 kernel, whatever `use_kernel` says
(the flag stays in the signatures for parity with `repro`); on a CPU
tensor it is the kernel's plain PyTorch version. Inputs that are not
tensors land on ``cuda``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch._device import as_tensor
from repro_torch.kernels.ops import exit_gate


@dataclass(frozen=True)
class GateResult:
    """Per-sample gate outputs (all tensors share leading batch dims)."""

    confidence: torch.Tensor  # max softmax(z/T)
    prediction: torch.Tensor  # argmax, int32
    entropy: torch.Tensor  # entropy of softmax(z/T), nats
    exit_mask: torch.Tensor  # True -> classify at this exit (on-device)


def gate_statistics(logits, temperature=1.0, use_kernel: bool = False):
    """(confidence, prediction, entropy) of softmax(logits / T).

    logits: (..., num_classes); temperature: a scalar. `use_kernel` is
    accepted for API parity: the device of `logits` decides (CUDA -> K1).
    """
    return exit_gate(logits, temperature)


def apply_gate(
    logits,
    p_tar: float,
    temperature=1.0,
    criterion: str = "confidence",
    entropy_threshold: Optional[float] = None,
    use_kernel: bool = False,
) -> GateResult:
    """The paper's offloading gate.

    criterion 'confidence': exit iff max softmax(z/T) >= p_tar (SPINN / paper).
    criterion 'entropy':    exit iff H(softmax(z/T)) <= entropy_threshold
                            (BranchyNet's rule).
    """
    conf, pred, ent = gate_statistics(logits, temperature, use_kernel=use_kernel)
    if criterion == "confidence":
        mask = conf >= p_tar
    elif criterion == "entropy":
        if entropy_threshold is None:
            raise ValueError("entropy criterion needs entropy_threshold")
        mask = ent <= entropy_threshold
    else:
        raise ValueError(f"unknown criterion {criterion!r}")
    return GateResult(conf, pred, ent, mask)


def cascade_gate(exit_logits_list, final_logits, p_tar=None, temperatures=None,
                 plan=None):
    """Multi-branch cascade (paper Sec. IV-F).

    Walks the exits in order; each sample is classified by the FIRST exit
    whose confidence clears p_tar, else by the final (cloud) head.

    Calibration comes either from `plan` (an OffloadPlan: per-exit
    CalibratorState + p_tar) or from the legacy `temperatures` list with an
    explicit `p_tar`; an explicit p_tar overrides the plan's.

    Returns dict with:
      exit_index: (batch,) int32, index of serving exit (len(exits) = cloud)
      prediction: (batch,) int32
      confidence: (batch,) float32 (of the serving head)
    """
    n_exits = len(exit_logits_list)
    exit_logits_list = [as_tensor(z) for z in exit_logits_list]
    final_logits = as_tensor(final_logits)
    if plan is not None:
        if p_tar is None:
            p_tar = plan.p_tar
        exit_logits_list = [
            plan.calibrated_logits(z, i) for i, z in enumerate(exit_logits_list)
        ]
        temperatures = [1.0] * n_exits
    elif p_tar is None:
        raise ValueError("cascade_gate needs p_tar or plan")
    if temperatures is None:
        temperatures = [1.0] * n_exits
    batch = final_logits.shape[0]
    exit_index = torch.full((batch,), n_exits, dtype=torch.int32, device=final_logits.device)
    prediction = torch.argmax(final_logits.to(torch.float32), dim=-1).to(torch.int32)
    confidence, _, _ = gate_statistics(final_logits)
    # walk backwards so the earliest qualifying exit wins
    for i in range(n_exits - 1, -1, -1):
        conf, pred, _ = gate_statistics(exit_logits_list[i], temperatures[i])
        take = conf >= p_tar
        exit_index = torch.where(take, torch.full_like(exit_index, i), exit_index)
        prediction = torch.where(take, pred, prediction)
        confidence = torch.where(take, conf, confidence)
    return {
        "exit_index": exit_index,
        "prediction": prediction,
        "confidence": confidence,
    }
