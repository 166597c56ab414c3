"""Losses: BranchyNet-style joint multi-exit objective (port of
`repro.training.losses`).

L = L_final + sum_i w_i * L_exit_i  (+ moe aux)   [Teerapittayanon+ 2016,
the training recipe the paper uses for B-AlexNet; identical form for the
LM architectures with next-token CE.]

Plain PyTorch under autograd, as the reference is plain `jnp`: no kernel
of the port has a backward, and none is on this path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def softmax_xent(logits, labels):
    """Mean cross-entropy. logits (..., C), labels (...) integer."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels.to(torch.int64)[..., None])[..., 0]
    return -torch.mean(ll)


def multi_exit_loss(outputs, labels, exit_weights, moe_aux_weight: float = 0.01):
    """outputs: {logits, exit_logits, [moe_aux_loss]}.

    Returns (scalar loss, metrics dict of 0-d tensors).
    """
    final = softmax_xent(outputs["logits"], labels)
    loss = final
    metrics = {"loss_final": final}
    for i, (ex, w) in enumerate(zip(outputs["exit_logits"], exit_weights)):
        li = softmax_xent(ex, labels)
        loss = loss + w * li
        metrics[f"loss_exit{i}"] = li
    aux = outputs.get("moe_aux_loss", None)
    if aux is not None:
        loss = loss + moe_aux_weight * aux
        metrics["moe_aux"] = aux
    metrics["loss"] = loss
    return loss, metrics
