"""Serving step factories: prefill and single-token decode with the
calibrated early-exit gate fused into the step (port of
`repro.launch.serve`).

serve_step returns, besides the final logits, per-exit (confidence,
prediction) computed from calibrated side-branch logits -- the runtime
(`repro_torch.offload.engine`) uses them to stop early / route between
the edge and cloud partitions. On the card every exit's gate is one K1
launch (`core.exits.gate_statistics`).

Calibration comes from an `OffloadPlan` (one CalibratorState per exit)
or, as a legacy shim, from a raw `temperatures` list: the plan path
gates the calibrated float32 logits at T = 1, the shim gates the raw
logits at T inside the kernel.

The steps run on `device` (``cuda`` unless the caller passes ``"cpu"``):
token batches (and an encoder-decoder's ``encoder_frames``) land there,
and params that live elsewhere raise ValueError. A decode step updates
its caches in place.
"""
from __future__ import annotations

import torch

from repro_torch._device import as_tensor, require_device, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.exits import gate_statistics
from repro_torch.core.policy import OffloadPlan
from repro_torch.models import registry


def _make_exit_gater(cfg: ModelConfig, plan, temperatures):
    """-> gates(per_exit_logits_list) -> [(conf, pred, entropy), ...].

    Exactly one of plan/temperatures may be given; neither means T=1
    everywhere (the uncalibrated baseline).
    """
    n_exits = len(cfg.exit_layers)
    if plan is not None:
        if temperatures is not None:
            raise ValueError("pass plan OR temperatures, not both")
        if plan.num_exits != n_exits:
            raise ValueError(
                f"plan covers {plan.num_exits} exit(s) but {cfg.name} "
                f"has {n_exits}"
            )

        def gates(logits_list):
            return [
                gate_statistics(plan.calibrated_logits(l, i))
                for i, l in enumerate(logits_list)
            ]

        return gates
    temps = temperatures or [1.0] * n_exits

    def gates(logits_list):
        return [gate_statistics(l, t) for l, t in zip(logits_list, temps)]

    return gates


def _stack_gates(gates, b, device):
    """(exit_confidence (n_exits, b), exit_prediction (n_exits, b))."""
    if not gates:
        return (torch.zeros((0, b), device=device),
                torch.zeros((0, b), dtype=torch.int32, device=device))
    return torch.stack([g[0] for g in gates]), torch.stack([g[1] for g in gates])


def make_prefill_step(cfg: ModelConfig, plan: OffloadPlan = None,
                      temperatures=None, device=None):
    gater = _make_exit_gater(cfg, plan, temperatures)
    device = resolve_device(device)

    def prefill_step(params, batch):
        require_device(params["embed"]["w"].device, device, "the params")
        batch = {k: as_tensor(v, device).to(device) for k, v in batch.items()}
        tokens = batch["tokens"]
        with torch.no_grad():
            out = registry.forward_prefill(params, cfg, batch)
            conf, pred = _stack_gates(gater([l[:, 0, :] for l in out["exit_logits"]]),
                                      tokens.shape[0], device)
        return {
            "logits": out["logits"],
            "exit_confidence": conf,
            "exit_prediction": pred,
            "caches": out["caches"],
        }

    return prefill_step


def make_serve_step(cfg: ModelConfig, plan: OffloadPlan = None,
                    temperatures=None, device=None):
    """One decode token + fused exit gates. (params, token, caches, pos) ->
    ({token, logits, exit_confidence, exit_prediction}, caches)."""
    gater = _make_exit_gater(cfg, plan, temperatures)
    device = resolve_device(device)

    def serve_step(params, token, caches, pos):
        require_device(params["embed"]["w"].device, device, "the params")
        token = as_tensor(token, device).to(device)
        with torch.no_grad():
            out, caches = registry.decode_step(params, cfg, token, caches, pos)
            logits = out["logits"][:, 0, :]
            conf, pred = _stack_gates(gater([l[:, 0, :] for l in out["exit_logits"]]),
                                      token.shape[0], device)
            next_token = torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)
        return (
            {
                "token": next_token,
                "logits": logits,
                "exit_confidence": conf,
                "exit_prediction": pred,
            },
            caches,
        )

    return serve_step
