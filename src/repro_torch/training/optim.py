"""AdamW + schedules + global-norm clipping (port of
`repro.training.optim`).

A functional update over a parameter tree (nested dicts of tensors), with
the reference's arithmetic kept exactly, element by element:

* learning rate: linear warmup, then cosine decay to ``min_lr_frac``, in
  float32 (`schedule`);
* clip scale ``min(1, clip_norm / (gnorm + 1e-9))`` over the global norm
  of all gradients (1e-9, not torch's 1e-6);
* bias-corrected moments, ``eps`` added after the square root;
* decoupled weight decay on tensors with ndim >= 2 only.

The step count, the learning rate and the clip scale stay 0-d tensors on
the parameters' device, so an update never waits on the host.
`torch.optim.AdamW` is not used: its clip and decay differ.
`state_specs` lays out the moments over a described mesh (ZeRO-1), for
`launch.dryrun`'s per-card bytes.

Over a model axis (``split``: which gradient leaves, or which blocks of
a packed leaf's dim, are this rank's block of a split leaf, and the
axis's process group) the global norm adds the split elements' squares
over the ranks, one all-reduce of the per-leaf sums, and counts each
replicated element once: every rank gets the one device's norm, so the
clip scale and the update are the same on every rank, and each rank
updates its own blocks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.utils._pytree as pytree

from repro_torch.launch.mesh import all_sum


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


# the in-place update takes a leaf a slice of its first dim at a time, each
# slice of at most this many elements (one float32 temporary 256 MB)
INPLACE_SLICE = 1 << 26


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: dict
    nu: dict


def schedule(cfg: AdamWConfig, step):
    """Learning rate at `step` (a 0-d tensor or a number), float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(params) -> OptState:
    """Zero float32 moments shaped like `params`, step 0, on their device."""
    leaves = pytree.tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = pytree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
    return OptState(torch.zeros((), dtype=torch.int32, device=device), zeros,
                    pytree.tree_map(torch.clone, zeros))


def _square_sums(x, parts):
    """(the sum of squares of `x`'s elements split over the model axis,
    that of its whole ones), float32, for a leaf whose blocks are `parts`
    (`global_norm`)."""
    dim, blocks = parts
    sums = [torch.zeros((), device=x.device)] * 2
    for part, (_, split) in zip(torch.split(x, [n for n, _ in blocks], dim=dim), blocks):
        sums[not split] = sums[not split] + torch.sum(torch.square(part.to(torch.float32)))
    return tuple(sums)


def global_norm(tree, split=None):
    """sqrt of the sum of every leaf's squares (float32). `split`: (each
    leaf's blocks in `tree_leaves` order, as `sharding.model_parts` gives
    them, each this rank's block of one split over the model axis or
    whole; the axis's group): the split elements' sums are added over the
    ranks first (one all-reduce of a sum a leaf), the whole ones counted
    once."""
    leaves = pytree.tree_leaves(tree)
    if split is None or not any(s for _, blocks in split[0] for _, s in blocks):
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))
    flags, group = split
    pairs = [_square_sums(x, f) for x, f in zip(leaves, flags)]
    reduced = all_sum(torch.stack([p[0] for p in pairs]), group)
    return torch.sqrt(sum((reduced + torch.stack([p[1] for p in pairs])).unbind()))


@torch.no_grad()
def update(cfg: AdamWConfig, params, grads, state: OptState, inplace: bool = False,
           split=None):
    """Returns (new_params, new_state, metrics). The inputs are not
    modified, unless `inplace`: then each parameter and moment is
    overwritten with its new value, leaf by leaf and a slice of
    `INPLACE_SLICE` elements of its first dim at a time, and the returned
    trees hold the same tensors: the memory of one copy of the parameters
    and float32 moments and a slice's temporaries, where the functional
    update holds two copies and a leaf's temporaries. The arithmetic is
    the same either way, element by element. `split` as in
    `global_norm`, for the leaves of `grads`."""
    gnorm = global_norm(grads, split)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))

    def adamw(p, g, mu, nu, decay):
        g = g.to(torch.float32) * scale
        new_mu = cfg.b1 * mu + (1 - cfg.b1) * g
        new_nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
        mhat = new_mu / b1c
        nhat = new_nu / b2c
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        if decay:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), new_mu, new_nu

    def upd(p, g, mu, nu):
        if not inplace:
            return adamw(p, g, mu, nu, p.dim() >= 2)
        # a slice of the first dim at a time: the same elementwise
        # arithmetic, with float32 temporaries of a slice, not of the leaf
        rows = max(1, INPLACE_SLICE // max(1, p[0].numel())) if p.dim() else 1
        for i in range(0, p.shape[0] if p.dim() else 1, rows):
            sl = slice(i, i + rows) if p.dim() else ...
            new = adamw(p[sl], g[sl], mu[sl], nu[sl], p.dim() >= 2)
            for dst, src in zip((p[sl], mu[sl], nu[sl]), new):
                dst.copy_(src)
        return p, mu, nu

    # leaves are matched by key, whatever each dict's insertion order
    out = pytree.tree_map(upd, params, grads, state.mu, state.nu)

    def part(i):
        return pytree.tree_map(lambda o: o[i], out, is_leaf=lambda o: isinstance(o, tuple))

    return part(0), OptState(step, part(1), part(2)), {"grad_norm": gnorm, "lr": lr}


def state_specs(param_specs, zero1: bool = False, dp_axes=("data",), param_shapes=None,
                dp_size: int = 1) -> OptState:
    """Specs (tuples, as `repro_torch.sharding` makes them) for the
    OptState, given the params' specs.

    zero1=True: shard each moment's first replicated dim that `dp_size`
    divides over `dp_axes` (ZeRO-1 optimizer sharding). `param_shapes` (a
    matching tree of tensors or meta tensors) is needed to check
    divisibility; without it the first replicated dim is taken.
    """
    def is_spec(x):
        return isinstance(x, tuple)

    def moment_spec(spec, shape=None):
        if not zero1:
            return spec
        parts = list(spec) if spec else ([None] * len(shape) if shape is not None else [])
        for i, s in enumerate(parts):
            if s is None and (shape is None or shape[i] % max(dp_size, 1) == 0):
                parts[i] = dp_axes[0] if len(dp_axes) == 1 else tuple(dp_axes)
                return tuple(parts)
        return spec

    specs, treedef = pytree.tree_flatten(param_specs, is_leaf=is_spec)
    shapes = ([None] * len(specs) if param_shapes is None
              else [tuple(t.shape) for t in pytree.tree_leaves(param_shapes)])
    mu = pytree.tree_unflatten([moment_spec(s, sh) for s, sh in zip(specs, shapes)], treedef)
    return OptState((), mu, mu)
