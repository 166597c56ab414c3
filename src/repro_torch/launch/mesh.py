"""Device meshes (counterpart of `repro.launch.mesh`): described ones, and
the mesh of ranks a `torch.distributed` launch gives.

The reference builds TPU v5e meshes of real devices: one pod of 256 chips
as (data=16, model=16), or two pods, 512 chips, as (pod=2, data=16,
model=16), where the pod axis carries data parallelism only. A
`MeshSpec` describes a mesh by its axis names and sizes and needs no
device: `repro_torch.sharding` reads it to lay out the specs of every
parameter, cache and batch leaf, and `launch.dryrun` divides each leaf's
bytes by the product of the mesh axes that shard it, to give the bytes
one card of such a mesh would hold. The production meshes stay
described: 256 or 512 ranks are not on one machine.

`join_ranks` makes a mesh real: one process per rank, as
``python -m torch.distributed.run --nproc-per-node W`` starts them. It
returns a (data=W/M, model=M) `MeshSpec` bound to the process group (a
`torch.distributed.device_mesh.DeviceMesh`) and to the rank's device:
ranks r and r' share a model group when r // M == r' // M, and the
model group holds the ranks that split one replica's parameters
(`sharding.local_shards`); with M = 1 every rank is a full replica.
`sharding.fleet_mesh` binds a 1-D ``"cells"`` mesh the same way.

The collectives below are the only ones the port issues. They are
all-reduces, the one collective that both NCCL and gloo take on CUDA
tensors, so the same code runs on either backend. While
`record_collectives` is open each one is also logged (its kind, the
bytes of its operand, a count, and with ``timed`` its seconds on the
host clock between two device syncs), under the pass that issued it: the
forward, the backward, or a checkpointed layer's recompute during the
backward. A described mesh traced as one of its ranks (`MeshSpec.as_rank`,
the dry run's) has no process group: its collectives are logged and not
issued, so a step of a 256-rank mesh can be traced in one process.

On a differentiable path a collective goes through one of the three
autograd functions of the model axis (Megatron's conjugate pairs), never
through `all_sum` itself, which autograd does not see:

  `model_sum`    forward: the sum over the model ranks (a vocab-parallel
                 embedding's rows, a row-parallel product's float32
                 partials); backward: identity, since every rank's output
                 gradient is already the whole one.
  `model_grad`   forward: identity; backward: the sum of the ranks'
                 gradients (in float32, rounded once). For a replicated
                 activation entering a split region (the MLP's, q/k/v's,
                 the heads' and the MoE buffer's input) and for a replicated
                 leaf or gate applied to this rank's heads or slots
                 (``q_norm``, ``k_norm``, the MoE gates): each rank's
                 gradient covers only its part.
  `model_gather` forward: the shards gathered whole along a dim (the
                 vocab); backward: this rank's slice of the gradient,
                 since the loss above it is the same on every rank.

`gather_whole` is the inverse of `sharding.local_shards`: a local tree
back to whole leaves, leaf by leaf to the host (checkpoints), a packed
dim (`sharding.Packed`) block by block.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field, replace
from typing import Any, Optional, Tuple

import torch

from repro_torch._device import rank_device


@dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis names and sizes, in order; with `device_mesh` (and
    `device`, this rank's) it is bound to a process group, else it is
    only described. A described mesh with `rank_coords` stands for that
    rank of it, without a process group (`as_rank`)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device_mesh: Any = field(default=None, compare=False, repr=False)
    device: Optional[torch.device] = field(default=None, compare=False)
    rank_coords: Optional[Tuple[int, ...]] = field(default=None, compare=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape) or min(self.shape, default=1) < 1:
            raise ValueError(f"mesh axes {self.axis_names} do not fit sizes {self.shape}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        return dict(zip(self.axis_names, self.shape))[name]

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.shape)

    def group(self, axis: str):
        """The process group along `axis` (None when the mesh is only
        described, or this rank is not in it)."""
        if self.device_mesh is None or self.coordinate(axis) is None:
            return None
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> Optional[int]:
        """This rank's index along `axis`: None when the mesh is only
        described (and stands for no rank) or does not hold this rank."""
        if self.device_mesh is None:
            return None if self.rank_coords is None else self.rank_coords[
                self.axis_names.index(axis)]
        coord = self.device_mesh.get_coordinate()
        return None if coord is None else coord[self.axis_names.index(axis)]

    def as_rank(self, coords=None) -> "MeshSpec":
        """This described mesh standing for the rank at `coords` (all 0 by
        default): its coordinates are known, it has no process group, and
        its collectives only run under `record_collectives`."""
        if self.device_mesh is not None:
            raise ValueError("as_rank describes a rank of a described mesh, not of a bound one")
        coords = tuple(coords) if coords is not None else (0,) * len(self.shape)
        if len(coords) != len(self.shape) or not all(0 <= c < n for c, n in
                                                     zip(coords, self.shape)):
            raise ValueError(f"coordinates {coords} are not a rank of {self.shape}")
        return replace(self, rank_coords=coords)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's production layout: (data=16, model=16), or with
    `multi_pod` (pod=2, data=16, model=16)."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_debug_mesh(data: int = 1, model: int = 1) -> MeshSpec:
    """A (data, model) mesh of any size, for tests and `dryrun --mesh`."""
    return MeshSpec(("data", "model"), (data, model))


def join_ranks(device=None, model: int = 1) -> Tuple[MeshSpec, str]:
    """Join the process group of a `torch.distributed.run` launch and
    return (the (data=W/model, model) mesh bound to it, the backend).
    ValueError when `model` does not divide the W ranks.

    The rank's device and backend follow `_device.rank_device`: a card
    per rank with NCCL, or every rank on ``cuda:0`` with gloo when the
    ranks outnumber the cards, or the CPU with gloo when `device` is
    ``"cpu"``. Without a GPU it raises unless `device` is ``"cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                           "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"join_ranks runs under `python -m torch.distributed.run`; "
                           f"the environment lacks {missing}")
    world = int(os.environ["WORLD_SIZE"])
    model = int(model)
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide {world} ranks")
    dev, backend = rank_device(device, int(os.environ["LOCAL_RANK"]),
                               int(os.environ["LOCAL_WORLD_SIZE"]))
    if dev.type == "cuda":
        # bind the card before the group and the mesh: DeviceMesh would
        # otherwise pick cuda:LOCAL_RANK, which two ranks on one card lack
        torch.cuda.init()
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, this rank "
                               f"needs {backend}")
    else:
        dist.init_process_group(backend)
    shape = (world // model, model)
    dm = DeviceMesh(dev.type, torch.arange(world).reshape(shape),
                    mesh_dim_names=("data", "model"))
    return MeshSpec(("data", "model"), shape, device_mesh=dm, device=dev), backend


# ---------------------------------------------------------------- collectives
PASSES = ("forward", "backward", "recompute")


def _pass(backward: bool) -> str:
    """The pass issuing a collective: a backward function's own, else a
    forward run inside the autograd engine (a checkpointed layer's
    recompute), else the forward."""
    if backward:
        return "backward"
    return "recompute" if torch._C._current_graph_task_id() != -1 else "forward"


class CollectiveLog:
    """Per pass (`PASSES`) and collective kind (the reference's names):
    the operand bytes and the count of the collectives issued while it is
    open, and with `timed` the host seconds each took between two device
    syncs (`passes`); `bytes`, `counts` and `seconds` sum them over the
    passes."""

    def __init__(self, timed: bool = False):
        self.timed = timed
        self.passes = {p: {"bytes": defaultdict(int), "counts": defaultdict(int),
                           "seconds": defaultdict(float)} for p in PASSES}

    def _total(self, what):
        out = {}
        for d in self.passes.values():
            for kind, v in d[what].items():
                out[kind] = out.get(kind, 0) + v
        return out

    @property
    def bytes(self):
        return self._total("bytes")

    @property
    def counts(self):
        return self._total("counts")

    @property
    def seconds(self):
        return self._total("seconds")

    def add(self, kind: str, x: torch.Tensor, where: str = "forward"):
        self.passes[where]["bytes"][kind] += x.numel() * x.element_size()
        self.passes[where]["counts"][kind] += 1

    def add_seconds(self, kind: str, s: float, where: str = "forward"):
        self.passes[where]["seconds"][kind] += s

    def by_pass(self):
        """{pass: {"counts": ..., "bytes": ...}} of the passes that issued
        a collective."""
        return {p: {"counts": dict(d["counts"]), "bytes": dict(d["bytes"])}
                for p, d in self.passes.items() if d["counts"]}


_LOG: Optional[CollectiveLog] = None


@contextlib.contextmanager
def record_collectives(timed: bool = False):
    """Log every collective issued inside the block (`CollectiveLog`)."""
    global _LOG
    prev, _LOG = _LOG, CollectiveLog(timed)
    try:
        yield _LOG
    finally:
        _LOG = prev


def _sync(x: torch.Tensor):
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def all_sum(x: torch.Tensor, group, backward: bool = False) -> torch.Tensor:
    """Sum `x` over the ranks of `group`, in place; returns `x`. A None
    group is a described mesh's (`MeshSpec.as_rank`): the call is logged
    and leaves `x` as it is, and outside `record_collectives` it raises,
    since no rank would add its part. `backward`: issued by a backward
    function (logged under that pass)."""
    import torch.distributed as dist

    log = _LOG
    if log is not None:
        where = _pass(backward)
        log.add("all-reduce", x, where)
    if group is None:
        if log is None:
            raise ValueError("a collective over a described mesh (no process group) runs "
                             "only under record_collectives")
        return x
    if log is not None and log.timed:
        _sync(x)
        t0 = time.perf_counter()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        _sync(x)
        log.add_seconds("all-reduce", time.perf_counter() - t0, where)
        return x
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def gather_blocks(block: torch.Tensor, index: int, n: int, group) -> torch.Tensor:
    """(n, *block.shape): every rank's `block` at its `index`. An
    all-reduce of a zeroed buffer into which each rank writes its own
    block: exact, since x + 0 = x (NaN and infinities included), and
    taken by gloo on CUDA tensors, which gloo's all-gather is not."""
    out = block.new_zeros((n,) + tuple(block.shape))
    out[index] = block
    return all_sum(out, group)


def gather_cat(block: torch.Tensor, index: int, n: int, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `block` concatenated along `dim` in rank order (one
    `gather_blocks`)."""
    d = dim % block.dim()
    return gather_blocks(block.contiguous(), index, n, group).movedim(0, d).flatten(d, d + 1)


# ------------------------------------------- differentiable collectives
class _ModelSum(torch.autograd.Function):
    """Forward: `all_sum` over the group, in place on `x` (marked dirty:
    the callers pass a tensor no other op saved). Backward: identity."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.mark_dirty(x)
        return all_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelGrad(torch.autograd.Function):
    """Forward: identity. Backward: the gradient summed over the group in
    float32 and rounded once to its dtype."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = g.to(torch.float32, copy=True).contiguous()
        return all_sum(total, ctx.group, backward=True).to(g.dtype), None


class _ModelGather(torch.autograd.Function):
    """Forward: the ranks' shards concatenated along `dim`. Backward: this
    rank's slice of the gradient (no collective)."""

    @staticmethod
    def forward(ctx, x, index, n, group, dim):
        ctx.index, ctx.dim, ctx.size = index, dim % x.dim(), x.shape[dim]
        return gather_cat(x, index, n, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None, None


def model_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the model ranks of `group`, in place; the
    gradient passes through unchanged (each rank's output gradient is the
    whole one). A described mesh's None group leaves `x` as it is."""
    return _ModelSum.apply(x, group)


def model_grad(x: torch.Tensor, group) -> torch.Tensor:
    """`x` unchanged; its gradient is summed over the model ranks of
    `group` (float32, rounded once). For a replicated activation or leaf
    whose uses on this rank cover only its part of a split width."""
    return _ModelGrad.apply(x, group)


def model_gather(x: torch.Tensor, index: int, n: int, group, dim: int = -1) -> torch.Tensor:
    """Every model rank's shard of `x` concatenated along `dim`; the
    gradient of the whole is cut back to this rank's shard."""
    return _ModelGather.apply(x, index, n, group, dim)


def gather_whole(tree, specs, mesh: MeshSpec):
    """The whole leaves of a tree of this rank's slices (the inverse of
    `sharding.local_shards` under the same `specs`), each gathered over
    the axes that split it and moved to the host as it comes, so the card
    holds one whole leaf at a time. Every rank of the split axes must
    call it; each gets the whole tree."""
    import torch.utils._pytree as pytree

    from repro_torch.sharding import Packed

    leaves, treedef = pytree.tree_flatten(tree)
    spec_leaves = pytree.tree_leaves(specs, is_leaf=lambda s: isinstance(s, tuple))
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(spec_leaves)} specs")
    out = []
    for leaf, spec in zip(leaves, spec_leaves):
        whole = leaf
        for dim, ax in enumerate(spec):
            if isinstance(ax, Packed):
                whole = _gather_packed(whole, dim, ax.blocks, mesh)
                continue
            if ax is None or mesh.axis_size(ax) == 1:
                continue
            if not isinstance(ax, str):
                raise ValueError(f"gather_whole takes one axis a dim, not {ax}")
            whole = gather_cat(whole, mesh.coordinate(ax), mesh.axis_size(ax), mesh.group(ax),
                               dim)
        out.append(whole.detach().cpu())
    return pytree.tree_unflatten(out, treedef)


def _gather_packed(x, dim: int, blocks, mesh: MeshSpec) -> torch.Tensor:
    """The whole of a packed dim (`sharding.Packed`'s ``blocks``: (global
    size, axis or None), one axis among them) from every rank's slice
    `x`: each split block's blocks in rank order, each whole block once."""
    (axis,) = {a for _, a in blocks if a is not None}
    n = mesh.axis_size(axis)
    every = gather_blocks(x.contiguous(), mesh.coordinate(axis), n, mesh.group(axis))
    parts, start = [], 0
    for size, a in blocks:
        k = size // n if a is not None else size
        piece = every.narrow(dim + 1, start, k)
        parts.append(piece.movedim(0, dim).flatten(dim, dim + 1) if a is not None else piece[0])
        start += k
    return torch.cat(parts, dim)
