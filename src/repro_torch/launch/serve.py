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

The steps run on `device` (``cuda`` unless the caller passes ``"cpu"``,
or the bound mesh's device): token batches (and an encoder-decoder's
``encoder_frames``) land there, and params that live elsewhere raise
ValueError. A decode step updates its caches in place.

Over a (data, model) mesh of ranks (``mesh=``, `launch.mesh.join_ranks`;
params from `init_params(mesh=)` or `params_from_jax(mesh=)`, caches from
`registry.init_cache(mesh=)`): every rank of a step is called with the
same global batch and keeps its rows (`data.pipeline.shard_batch`, where the
data axis divides them, as `sharding.batch_specs_tree` lays them out;
the MoE blocks then run under `moe.data_parallel`, one device's
capacity on the global batch). The model runs under `sharding.use_mesh`
(its heads, ``d_ff``, experts and vocab split over the model axis), each
exit's gate (one K1) runs on the rank's rows of whole-vocab exit logits,
and the outputs are gathered over the data axis at the step's end, so
every rank returns what one device returns, but for the decode step's
``logits``, which stay this rank's vocab shard (the next token is the
global argmax, `transformer.vocab_argmax`). Every LM family runs over a
model axis above one rank, the encoder-decoder (whisper) too.
"""
from __future__ import annotations

import torch

from repro_torch._device import as_tensor, require_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.exits import gate_statistics
from repro_torch.core.policy import OffloadPlan
from repro_torch.models import registry, transformer
from repro_torch.sharding import mesh_device, mesh_scope, rows_of


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
                      temperatures=None, device=None, mesh=None):
    """Prefill + fused exit gates. (params, batch) -> {logits (b, 1, V),
    exit_confidence, exit_prediction (n_exits, b), caches}; over `mesh`
    the caches are this rank's (its rows and kv heads)."""
    gater = _make_exit_gater(cfg, plan, temperatures)
    device = mesh_device(mesh, device)

    def prefill_step(params, batch):
        require_device(params["embed"]["w"].device, device, "the params")
        batch = {k: as_tensor(v, device).to(device) for k, v in batch.items()}
        local, sharded, gather = rows_of(batch, mesh)
        with torch.no_grad(), mesh_scope(mesh, sharded):
            out = registry.forward_prefill(params, cfg, local)
            conf, pred = _stack_gates(gater([l[:, 0, :] for l in out["exit_logits"]]),
                                      local["tokens"].shape[0], device)
            logits, conf, pred = gather(out["logits"]), gather(conf, 1), gather(pred, 1)
        return {
            "logits": logits,
            "exit_confidence": conf,
            "exit_prediction": pred,
            "caches": out["caches"],
        }

    return prefill_step


def make_serve_step(cfg: ModelConfig, plan: OffloadPlan = None,
                    temperatures=None, device=None, mesh=None):
    """One decode token + fused exit gates. (params, token, caches, pos) ->
    ({token, logits, exit_confidence, exit_prediction}, caches); over
    `mesh` the caches are this rank's and ``logits`` (b, V / model) is
    this rank's vocab shard."""
    gater = _make_exit_gater(cfg, plan, temperatures)
    device = mesh_device(mesh, device)

    def serve_step(params, token, caches, pos):
        require_device(params["embed"]["w"].device, device, "the params")
        token = as_tensor(token, device).to(device)
        local, sharded, gather = rows_of({"token": token}, mesh)
        with torch.no_grad(), mesh_scope(mesh, sharded):
            out, caches = registry.decode_step(params, cfg, local["token"], caches, pos)
            logits = out["logits"][:, 0, :]
            conf, pred = _stack_gates(gater([l[:, 0, :] for l in out["exit_logits"]]),
                                      local["token"].shape[0], device)
            next_token = transformer.vocab_argmax(logits, cfg).to(torch.int32)
            next_token, logits = gather(next_token), gather(logits)
            conf, pred = gather(conf, 1), gather(pred, 1)
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
