"""Train and eval steps (port of `repro.training.loop`).

`make_train_step(cfg, opt_cfg)` builds the (params, opt_state, batch) ->
(params, opt_state, metrics) step for any zoo architecture: the joint
loss under autograd (`torch.autograd.grad` over the parameter leaves),
then the functional AdamW `optim.update`. The LM families go through
`models.registry.forward_train` and `losses.multi_exit_loss` (the MoE aux
loss weighted by ``cfg.moe_aux_loss_weight``); the convnet through its
image loss. ``remat`` checkpoints the LM's layers (`registry`); the eval
step runs without it, as the reference's does. With ``inplace`` the
update overwrites the parameters and moments it was given (one copy of
the AdamW state on the card instead of two; `optim.update`).

Both steps run on `device` (``cuda`` unless the caller passes ``"cpu"``):
the batch and the parameters move there, and without a GPU and without a
named device the step raises instead of running on the CPU.

Data parallelism (``mesh``, a data mesh from `launch.mesh.join_ranks`):
every rank holds the same parameters and moments and takes its rows of
the global batch (`data.pipeline.data_rows`; a `Shard` is taken as
given). Each rank's loss is the mean over its rows, so the mean of the
ranks' gradients is the gradient of the global batch's mean: one
all-reduce of a flat bucket per dtype sums them, then the same AdamW
runs on every rank and the parameters stay equal. The MoE blocks run
under `moe.data_parallel`, global capacity and aux loss. The returned
losses are the global batch's (the mean of the ranks'; every shard has
the same size) and ``grad_norm`` is the reduced gradient's. Where the
ranks do not divide the batch every rank runs the one-device step on all
of it, and nothing is reduced.

Tensor parallelism (a (data, model) mesh with model > 1, from
`join_ranks(model=)`; params from `init_params(mesh=)` or
`params_from_jax(mesh=)`, moments from `optim.init` of them): the step
runs the model under `sharding.use_mesh`, each rank holding its slices;
every collective on the loss's path is one of `launch.mesh`'s autograd
functions, the loss is vocab-parallel (`losses.softmax_xent`), and a
rank's gradient of a split leaf is its block of one device's while a
replicated leaf's is the whole of it, the same on every model rank.
Gradients and metrics are averaged over the data axis only (as above),
the global norm adds the split leaves over the model axis and counts
the replicated ones once (`optim.global_norm`), and each rank updates
its blocks: the reference's one-device step, cut. Every LM family runs
so, the encoder-decoder (whisper, a tree of per-layer blocks) too.
The eval step over such a mesh returns whole-vocab logits
(`transformer.gather_vocab`) of the whole batch on every rank, as
calibration reads them.
"""
from __future__ import annotations

import contextlib

import torch
import torch.utils._pytree as pytree

from repro_torch import sharding
from repro_torch._device import as_tensor, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import Shard, shard_batch
from repro_torch.launch.mesh import all_sum
from repro_torch.models import moe, registry, transformer
from repro_torch.sharding import data_split, mesh_device, mesh_scope, rows_of
from repro_torch.training import optim
from repro_torch.training.losses import multi_exit_loss, softmax_xent


def loss_fn(params, cfg: ModelConfig, batch, remat: bool = True):
    """BranchyNet joint loss: final-head CE + sum_i w_i * exit_i CE (+ the
    weighted MoE aux loss for the LMs). Returns (loss, metrics dict of 0-d
    tensors)."""
    out = registry.forward_train(params, cfg, batch, remat=remat)
    if cfg.family == "convnet":
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
    return multi_exit_loss(out, batch["labels"], cfg.exit_loss_weights,
                           cfg.moe_aux_loss_weight, vocab=cfg.vocab_size)


def _on(device, params, batch):
    params = pytree.tree_map(lambda x: x.to(device), params)
    batch = {k: as_tensor(v, device).to(device) for k, v in batch.items()}
    return params, batch


def _mean_over(tensors, group, world: int):
    """Replace each tensor by its mean over the ranks: one all-reduce of a
    flat bucket per dtype (the sum, then a division by `world`)."""
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = list(tensors)
    for idx in by_dtype.values():
        flat = all_sum(torch.cat([tensors[i].reshape(-1) for i in idx]), group)
        flat.div_(world)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def whole_specs(cfg: ModelConfig, mesh):
    """{tree path: spec} of `cfg`'s whole params over `mesh` under the
    port's layout (`sharding.specs_by_path`); None without a model axis
    above one rank."""
    if sharding.model_size(mesh) == 1:
        return None
    return sharding.specs_by_path(registry.param_specs_shapes(cfg), mesh)


def make_grad_fn(cfg: ModelConfig, remat: bool = True, device=None, mesh=None):
    """The train step's first half, the counterpart of the reference's
    ``jax.value_and_grad(loss_fn, has_aux=True)``: (params, batch) ->
    (metrics, grads, params as the step saw them), on `device` and over
    `mesh` as `make_train_step` describes; the grads are a tree shaped
    like `params`, a split leaf's this rank's block, averaged over the
    data axis; the metrics are detached, the global batch's."""
    split = None if mesh is None else data_split(mesh)
    world = 1 if split is None else split[2]
    if device is None and mesh is not None:
        device = mesh.device

    def grad_fn(params, batch):
        dev = resolve_device(device)
        if world > 1 and not isinstance(batch, Shard):
            batch = shard_batch(batch, mesh)
        dp = world > 1 and batch.sharded
        group = split[0] if dp else None
        params, batch = _on(dev, params, batch)
        leaves, spec = pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        scope = (moe.data_parallel(group, split[1], world) if dp
                 else contextlib.nullcontext())
        with torch.enable_grad(), sharding.use_mesh(mesh), scope:
            loss, metrics = loss_fn(pytree.tree_unflatten(leaves, spec), cfg, batch, remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        del loss
        if dp:
            grads = _mean_over(list(grads), group, world)
            names = list(metrics)
            metrics = dict(zip(names, _mean_over([metrics[k].to(torch.float32) for k in names],
                                                 group, world)))
        return (metrics, pytree.tree_unflatten(list(grads), spec),
                pytree.tree_unflatten([p.detach() for p in leaves], spec))

    return grad_fn


def make_train_step(cfg: ModelConfig, opt_cfg: optim.AdamWConfig, remat: bool = True,
                    device=None, inplace: bool = False, mesh=None):
    grad_fn = make_grad_fn(cfg, remat, device, mesh)
    by_path = whole_specs(cfg, mesh)

    def train_step(params, opt_state, batch):
        metrics, grads, params = grad_fn(params, batch)
        split = None
        if by_path is not None:  # how the model axis splits each of the grads' leaves
            flat = pytree.tree_flatten_with_path(grads)[0]
            split = ([sharding.model_parts(by_path[sharding.path_str(p)], g.shape, mesh)
                      for p, g in flat], mesh.group("model"))
        params, opt_state, opt_metrics = optim.update(opt_cfg, params, grads, opt_state,
                                                      inplace=inplace, split=split)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, device=None, mesh=None):
    """Returns per-sample (exit_logits list, final logits) for calibration.
    Over `mesh` every rank is called with the same global batch and
    returns one device's whole-vocab logits of all of it."""

    def eval_step(params, batch):
        params, batch = _on(mesh_device(mesh, device), params, batch)
        rows, sharded, gather = rows_of(batch, mesh)
        with torch.no_grad(), mesh_scope(mesh, sharded):
            out = registry.forward_train(params, cfg, rows, remat=False)
            return {"logits": gather(transformer.gather_vocab(out["logits"], cfg)),
                    "exit_logits": [gather(transformer.gather_vocab(z, cfg))
                                    for z in out["exit_logits"]]}

    return eval_step
