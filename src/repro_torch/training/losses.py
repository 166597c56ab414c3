"""Losses: BranchyNet-style joint multi-exit objective (port of
`repro.training.losses`).

L = L_final + sum_i w_i * L_exit_i  (+ moe aux)   [Teerapittayanon+ 2016,
the training recipe the paper uses for B-AlexNet; identical form for the
LM architectures with next-token CE.]

Plain PyTorch under autograd, as the reference is plain `jnp`: no kernel
of the port has a backward, and none is on this path.

Over a model axis the LM heads' logits are this rank's vocab shard, and
`softmax_xent` given the global `vocab` is vocab-parallel (`_VocabXent`):
each row's maximum, its sum of exp(z - m) and its label's logit come
from the shards through two all-reduces of per-row float32 statistics,
so no rank holds a whole row. The loss is log S + m - z_y, the
reference's up to float32 reassociation, and the same on every rank;
its gradient is this shard's softmax minus this shard's one-hot, with no
collective.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import all_sum, gather_blocks
from repro_torch.models.layers import split_width


class _VocabXent(torch.autograd.Function):
    """Mean cross-entropy of logits split over the vocab: z (..., V/W) is
    this rank's block `index` of `n`, labels (...) global ids."""

    @staticmethod
    def forward(ctx, z, labels, group, index, n):
        zf = z.to(torch.float32)
        width = zf.shape[-1]
        # the shard maxima gathered whole (gloo takes no MAX on CUDA tensors)
        m = gather_blocks(zf.amax(-1), index, n, group).amax(0)
        local = labels.to(torch.int64) - index * width
        mine = (local >= 0) & (local < width)
        zy = zf.gather(-1, torch.where(mine, local, 0)[..., None])[..., 0] * mine
        stats = torch.stack([torch.exp(zf - m[..., None]).sum(-1), zy])
        del zf
        s, zy = all_sum(stats, group)
        lse = torch.log(s) + m
        ctx.save_for_backward(z, local, mine, lse)
        return torch.mean(lse - zy)

    @staticmethod
    def backward(ctx, g):
        z, local, mine, lse = ctx.saved_tensors
        grad = torch.exp(z.to(torch.float32) - lse[..., None])
        grad.scatter_add_(-1, torch.where(mine, local, 0)[..., None],
                          -mine[..., None].to(grad.dtype))
        grad *= g / lse.numel()
        return grad.to(z.dtype), None, None, None, None


def softmax_xent(logits, labels, vocab=None):
    """Mean cross-entropy. logits (..., C), labels (...) integer. With
    `vocab`, the global class count, and logits that are this rank's
    shard of it over the model axis (`layers.split_width`), the
    vocab-parallel loss."""
    split = None if vocab is None else split_width(logits.shape[-1], vocab)
    if split is not None:
        return _VocabXent.apply(logits, labels, *split)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels.to(torch.int64)[..., None])[..., 0]
    return -torch.mean(ll)


def multi_exit_loss(outputs, labels, exit_weights, moe_aux_weight: float = 0.01, vocab=None):
    """outputs: {logits, exit_logits, [moe_aux_loss]}; `vocab` as in
    `softmax_xent`.

    Returns (scalar loss, metrics dict of 0-d tensors).
    """
    final = softmax_xent(outputs["logits"], labels, vocab)
    loss = final
    metrics = {"loss_final": final}
    for i, (ex, w) in enumerate(zip(outputs["exit_logits"], exit_weights)):
        li = softmax_xent(ex, labels, vocab)
        loss = loss + w * li
        metrics[f"loss_exit{i}"] = li
    aux = outputs.get("moe_aux_loss", None)
    if aux is not None:
        loss = loss + moe_aux_weight * aux
        metrics["moe_aux"] = aux
    metrics["loss"] = loss
    return loss, metrics
