"""Train and eval steps (port of `repro.training.loop`, convnet branch).

`make_train_step(cfg, opt_cfg)` builds the (params, opt_state, batch) ->
(params, opt_state, metrics) step: the joint loss under autograd
(`torch.autograd.grad` over the parameter leaves), then the functional
AdamW `optim.update`. The reference dispatches through
`models.registry.forward_train`; the port calls `models.convnet.forward`
for ``family == "convnet"`` and raises for every other family, which
waits for the LM slice (with the registry itself).

Both steps run on `device` (``cuda`` unless the caller passes ``"cpu"``):
the batch and the parameters move there, and without a GPU and without a
named device the step raises instead of running on the CPU.
"""
from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from repro_torch._device import as_tensor, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.training import optim
from repro_torch.training.losses import softmax_xent


def _forward(params, cfg: ModelConfig, images):
    if cfg.family != "convnet":
        raise NotImplementedError(
            f"family {cfg.family!r}: only the convnet is ported; the LM families "
            "(and models.registry) wait for the LM slice"
        )
    from repro_torch.models import convnet

    return convnet.forward(params, images)


def loss_fn(params, cfg: ModelConfig, batch):
    """BranchyNet joint loss: final-head CE + sum_i w_i * exit_i CE.
    Returns (loss, metrics dict of 0-d tensors)."""
    out = _forward(params, cfg, batch["images"])
    labels = batch["labels"]
    final = softmax_xent(out["logits"], labels)
    loss = final
    metrics = {"loss_final": final}
    for i, (ex, w) in enumerate(zip(out["exit_logits"], cfg.exit_loss_weights)):
        li = softmax_xent(ex, labels)
        loss = loss + w * li
        metrics[f"loss_exit{i}"] = li
    metrics["loss"] = loss
    return loss, metrics


def _on(device, params, batch):
    params = pytree.tree_map(lambda x: x.to(device), params)
    batch = {k: as_tensor(v, device).to(device) for k, v in batch.items()}
    return params, batch


def make_train_step(cfg: ModelConfig, opt_cfg: optim.AdamWConfig, device=None):
    def train_step(params, opt_state, batch):
        dev = resolve_device(device)
        params, batch = _on(dev, params, batch)
        leaves, spec = pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, metrics = loss_fn(pytree.tree_unflatten(leaves, spec), cfg, batch)
            grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        params, opt_state, opt_metrics = optim.update(
            opt_cfg, pytree.tree_unflatten([p.detach() for p in leaves], spec),
            pytree.tree_unflatten(list(grads), spec), opt_state)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, device=None):
    """Returns per-sample (exit_logits list, final logits) for calibration."""

    def eval_step(params, batch):
        params, batch = _on(resolve_device(device), params, batch)
        with torch.no_grad():
            out = _forward(params, cfg, batch["images"])
        return {"logits": out["logits"], "exit_logits": out["exit_logits"]}

    return eval_step
