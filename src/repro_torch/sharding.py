"""Sharding rules over a described mesh (port of `repro.sharding`).

Conventions (Megatron-style tensor parallelism + (pod,) data parallelism):
  * batch dims shard on the data axes ('pod','data') when present;
  * attention heads / ffn hidden / vocab / MoE experts / mamba channels
    shard on the 'model' axis;
  * norms, routers, scalar SSM params replicate.

Parameter specs are assigned by *path rules* over the params tree, so they
can never drift from the initializers: `param_specs` walks the actual
tree. Stacked segments have one extra leading layer dim, which maps to
None (specs are aligned to trailing dims).

Every function here is pure shape arithmetic over a `launch.mesh.MeshSpec`
passed as ``mesh`` (None: no mesh, as the reference's ``set_mesh(None)``);
the reference keeps the mesh in module state instead. A spec is a tuple
with the entries of the reference's ``PartitionSpec``: one per dim, each
None, an axis name or a tuple of axis names (a one-name tuple is the
name, as ``PartitionSpec`` normalizes it).

`fleet_mesh` is the compiled fleet's 1-D ``"cells"`` mesh, bound to the
ranks of a `torch.distributed` launch (`launch.mesh`).

Tensor parallelism (a model axis above 1): `local_shards` cuts a full
tree into this rank's slices under `layout_specs`, and `use_mesh`
installs the mesh the models run under (the reference's ``set_mesh``;
module state, as the reference keeps it). The specs are the layout but
for mamba's packed leaves: the models read each leaf's local width and
`model_split`, and a leaf that `fit_spec` leaves whole (8 kv heads over
16 ranks, an odd vocabulary) is used whole. What the reference's
``"tp"`` constraints ask of the activations the port does with
collectives in the layers (`models.layers`, `models.attention`,
`models.moe`, `models.mamba`): a vocab-parallel
embedding, column-parallel products into the split widths, row-parallel
products reduced over the model axis, and logits gathered from their
vocab shards.

Mamba's packed leaves: ``in_proj`` packs the columns [z | x | B | C |
dt], ``conv_w`` / ``conv_b`` and the conv cache the channels [x | B | C].
The reference's rules split such a dim as one contiguous block, which
GSPMD may do with a layout; the port computes on the split, so a rank
must hold its SSD heads' z, x and dt and the whole of B and C (which feed
every head: both configs have one group). `layout_specs` and
`cache_layout` are `param_specs` and `cache_specs_tree` with those
dims `Packed`: a concatenation of blocks, each split over the model axis
or whole, a rank's slice its block of each split one followed by the
whole ones, in the column order. A mamba layer splits only where the
model axis divides its heads; elsewhere every leaf of it is whole and
every rank computes it. `param_specs` and `cache_specs_tree` stay the
reference's; every cut, gather and shape of a rank's tree goes by the
layout (`local_shards`, `local_shape`, `local_zeros`, `shard_bytes`,
`launch.mesh.gather_whole`, `model_parts`).

No counterpart: ``constrain`` (the reference's activation sharding
constraint): the port shards the batch once, at the step's input
(`training.loop.make_train_step(mesh=...)`, the serve steps), and each
rank runs the model on its rows, which is what the ``"dp"`` constraints
compute. Nor ``named_shardings``, which binds specs to JAX devices:
`local_shards` hands each rank its slices instead.
"""
from __future__ import annotations

import contextlib
import math
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch._device import resolve_device
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch.mesh import MeshSpec, gather_cat


# the mesh the models run under while `use_mesh` is open
_MESH: Optional[MeshSpec] = None


@contextlib.contextmanager
def use_mesh(mesh: Optional[MeshSpec]):
    """Run the models inside the block over `mesh` (None: one device):
    the counterpart of the reference's ``set_mesh``. The params must be
    this rank's `local_shards` of it."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def model_size(mesh: Optional[MeshSpec]) -> int:
    """Ranks along `mesh`'s model axis (1 without one)."""
    return axis_size(tp_axis(mesh), mesh)


def model_split():
    """(process group, this rank's index, ranks) along the model axis of
    the mesh in use, or None when there is no such axis above one rank.
    The group is None on a described mesh traced as one of its ranks."""
    mesh = _MESH
    if model_size(mesh) == 1:
        return None
    return mesh.group("model"), mesh.coordinate("model"), mesh.axis_size("model")


def data_split(mesh: Optional[MeshSpec]):
    """(process group, this rank's index, ranks) along the data axes of
    `mesh` (pod and data, row-major), or None when they hold one rank.
    The group is None on a described mesh traced as one of its ranks, and
    on a mesh with several data axes (only a described one has them)."""
    axes = dp_axes(mesh)
    n = axis_size(axes or None, mesh)
    if n == 1:
        return None
    group = mesh.group(axes[0]) if len(axes) == 1 else None
    return group, local_index(axes, mesh), n


# ------------------------------------------------ the steps over a mesh
def mesh_device(mesh, device):
    """A step's device: `device` if named, else a bound mesh's, else
    `resolve_device`'s."""
    if device is None and mesh is not None and mesh.device is not None:
        device = mesh.device
    return resolve_device(device)


@contextlib.contextmanager
def mesh_scope(mesh, sharded: bool):
    """Run the models under `mesh` (`use_mesh`), and the MoE blocks over
    the data axis when the rows are `sharded` over it."""
    from repro_torch.models import moe  # the models import this module

    with use_mesh(mesh), contextlib.ExitStack() as stack:
        if sharded:
            group, index, n = data_split(mesh)
            stack.enter_context(moe.data_parallel(group, index, n))
        yield


def rows_of(batch: dict, mesh):
    """(this rank's rows of a global batch as a dict, whether the ranks
    of the data axis hold different rows, a function that gathers a
    tensor's rows (along `dim`) over the data axis when they do)."""
    sh = None if mesh is None else shard_batch(batch, mesh)
    if sh is None or not sh.sharded:
        return batch, False, lambda x, dim=0: x
    group, index, n = data_split(mesh)
    return dict(sh), True, lambda x, dim=0: gather_cat(x, index, n, group, dim)


def _spec(*entries) -> tuple:
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def dp_axes(mesh: Optional[MeshSpec]) -> tuple:
    """The data-parallel axes of `mesh`, in mesh order."""
    return () if mesh is None else tuple(n for n in mesh.axis_names if n in ("pod", "data"))


def tp_axis(mesh: Optional[MeshSpec]) -> Optional[str]:
    return "model" if mesh is not None and "model" in mesh.axis_names else None


def _resolve(sym, mesh):
    if sym == "dp":
        return dp_axes(mesh) or None
    if sym == "tp":
        return tp_axis(mesh)
    return sym


def axis_size(ax, mesh: Optional[MeshSpec]) -> int:
    """Devices along a spec entry: 1 for None or no mesh."""
    if ax is None or mesh is None:
        return 1
    if isinstance(ax, (tuple, list)):
        return math.prod(mesh.axis_size(a) for a in ax)
    return mesh.axis_size(ax)


def fit_spec(spec_axes, shape, mesh: Optional[MeshSpec]) -> tuple:
    """Drop sharding on dims the mesh axes don't evenly divide (e.g. a
    global_batch=1 decode can't shard batch over 16 data shards)."""
    fitted = []
    for ax, dim in zip(spec_axes, shape):
        n = axis_size(ax, mesh)
        fitted.append(ax if (n > 1 and dim % n == 0) else (None if n > 1 else ax))
    return _spec(*fitted)


# ---------------------------------------------------------- param spec rules
# (path-regex, trailing-dim spec symbols). First match wins. The spec covers
# the LAST len(spec) dims; any leading dims (stacked scan layers) get None.
_RULES = [
    (r"embed/w$", ("tp", None)),
    (r"(lm_head|head)/w$", (None, "tp")),
    (r"pos_embed$", (None, None)),
    # attention
    (r"attn.*/w[qkv]$", (None, "tp", None)),
    (r"attn.*/b[qkv]$", ("tp", None)),
    (r"attn.*/wo$", ("tp", None, None)),
    (r"attn.*/(q_norm|k_norm)$", (None,)),
    # dense mlp
    (r"mlp/w_(gate|up)$", (None, "tp")),
    (r"mlp/w_down$", ("tp", None)),
    # moe (expert parallel on model axis)
    (r"moe/router$", (None, None)),
    (r"moe/w_(gate|up|down)$", ("tp", None, None)),
    # mamba
    (r"mamba/in_proj$", (None, "tp")),
    (r"mamba/dt_proj$", None),  # head-count width; replicate (split-proj variant)
    (r"mamba/conv_w$", (None, "tp")),
    (r"mamba/conv_b$", ("tp",)),
    (r"mamba/(A_log|D|dt_bias)$", ("tp",)),
    (r"mamba/norm_scale$", ("tp",)),
    (r"mamba/out_proj$", ("tp", None)),
    # convnet (paper's B-AlexNet): small; replicate
    (r"conv\d*/(w|b)$", None),
    (r"fc\d*/(w|b)$", None),
    # norms and everything else: replicate
    (r".*", None),
]


def path_str(path) -> str:
    """A tree path as the reference's `_path_str` writes it: dict keys and
    list indices joined by '/' (``exits/0/head/w``)."""
    return "/".join(str(k.key) if hasattr(k, "key") else str(k.idx) if hasattr(k, "idx")
                    else str(k) for k in path)


def spec_for(path: str, shape, mesh: Optional[MeshSpec]) -> tuple:
    ndim = len(shape)
    for pat, spec in _RULES:
        if re.search(pat, path):
            if spec is None:
                return ()
            spec = [_resolve(s, mesh) for s in spec]
            if ndim < len(spec):
                return ()
            return fit_spec([None] * (ndim - len(spec)) + spec, shape, mesh)
    return ()


def _map_with_path(fn, tree):
    leaves, treedef = pytree.tree_flatten_with_path(tree)
    return pytree.tree_unflatten([fn(path_str(p), leaf) for p, leaf in leaves], treedef)


def param_specs(params, mesh: Optional[MeshSpec]):
    """A spec tree matching `params` (tensors, meta tensors or anything
    with a ``shape``)."""
    return _map_with_path(lambda p, leaf: spec_for(p, leaf.shape, mesh), params)


# ------------------------------------------------- mamba's packed leaves
@dataclass(frozen=True)
class Packed:
    """A spec entry for a dim that concatenates blocks, each split over a
    mesh axis or whole: ``blocks`` is ((global size, axis or None), ...)
    in the dim's order. A rank's slice of the dim is its block of each
    split block and each whole block, in the same order."""

    blocks: tuple

    @property
    def size(self) -> int:
        return sum(n for n, _ in self.blocks)

    def local_size(self, mesh) -> int:
        return sum(n // axis_size(ax, mesh) for n, ax in self.blocks)

    def ranges(self, mesh) -> list:
        """This rank's (start, stop) ranges of the whole dim, in order."""
        out, start = [], 0
        for n, ax in self.blocks:
            k = axis_size(ax, mesh)
            i = 0 if k == 1 else local_index(ax, mesh)
            if i is None:
                raise ValueError("a packed dim is cut only for a rank of the mesh: a bound "
                                 "mesh or MeshSpec.as_rank")
            out.append((start + i * (n // k), start + (i + 1) * (n // k)))
            start += n
        return out


def _mamba_groups(flat):
    """{parent path: {leaf name: index into `flat`}} of the dicts holding a
    mamba layer's params (``.../mamba``) or its decode cache (``conv`` and
    ``ssd``), from (path, leaf) pairs."""
    groups = {}
    for i, (path, _) in enumerate(flat):
        parent, _, name = path.rpartition("/")
        if parent.endswith("mamba") or name in ("conv", "ssd"):
            groups.setdefault(parent, {})[name] = i
    return groups


def _relaid(tree, mesh, specs, relay):
    """`specs` (a spec tree over `tree`) with each mamba group's specs
    replaced by ``relay(shapes by name, specs by name, mesh)``."""
    if model_size(mesh) == 1:
        return specs
    flat = [(path_str(p), leaf) for p, leaf in pytree.tree_flatten_with_path(tree)[0]]
    spec_leaves, treedef = pytree.tree_flatten(specs, is_leaf=_is_spec)
    for members in _mamba_groups(flat).values():
        shapes = {k: tuple(flat[i][1].shape) for k, i in members.items()}
        got = relay(shapes, {k: spec_leaves[i] for k, i in members.items()}, mesh)
        for k, i in members.items():
            spec_leaves[i] = got[k]
    return pytree.tree_unflatten(spec_leaves, treedef)


def _mamba_params_layout(shapes, specs, mesh):
    """A mamba layer's specs: its heads' blocks of z, x and dt and whole B
    and C in the packed dims (dt_proj whole, as the reference's rule),
    the per-head leaves, ``norm_scale`` and ``out_proj`` split by heads as
    `param_specs` splits them; every leaf whole where the model axis does
    not divide the heads."""
    tp, m = tp_axis(mesh), model_size(mesh)
    if "A_log" not in shapes:
        return specs
    h, di, conv_ch = shapes["A_log"][-1], shapes["norm_scale"][-1], shapes["conv_w"][-1]
    if h % m:
        return {k: () for k in specs}
    bc = conv_ch - di
    out = dict(specs)
    proj = ((di, tp), (di, tp), (bc, None))
    if shapes["in_proj"][-1] == 2 * di + bc + h:  # dt packed in too
        proj += ((h, tp),)
    for k, blocks in (("in_proj", proj), ("conv_w", ((di, tp), (bc, None))),
                      ("conv_b", ((di, tp), (bc, None)))):
        out[k] = (None,) * (len(shapes[k]) - 1) + (Packed(blocks),)
    if "dt_proj" in out:
        out["dt_proj"] = ()
    return out


def _mamba_cache_layout(shapes, specs, mesh):
    """A mamba layer's decode cache: the conv buffer's channels packed as
    ``conv_w``'s, the SSD state split by heads as `cache_specs_tree`
    splits it; the model axis dropped from both where it does not divide
    the heads."""
    tp, m = tp_axis(mesh), model_size(mesh)
    if set(shapes) != {"conv", "ssd"}:
        return specs
    h, ph = shapes["ssd"][-3], shapes["ssd"][-2]
    conv = specs["conv"][:-1]
    if h % m:
        return {"conv": conv + (None,),
                "ssd": tuple(None if ax == tp else ax for ax in specs["ssd"])}
    di = h * ph
    return {"conv": conv + (Packed(((di, tp), (shapes["conv"][-1] - di, None))),),
            "ssd": specs["ssd"]}


def layout_specs(params, mesh: Optional[MeshSpec]):
    """The port's layout of a params tree (whole shapes; meta tensors will
    do) over `mesh`: `param_specs`, but for each mamba layer's packed
    leaves (`Packed`), or every leaf of the layer whole where the model
    axis does not divide its heads. What a rank's slices are cut and
    gathered by."""
    return _relaid(params, mesh, param_specs(params, mesh), _mamba_params_layout)


def cache_layout(cache_shapes, mesh: Optional[MeshSpec], batch_sharded: bool = True):
    """`cache_specs_tree` with each mamba layer's conv buffer `Packed`
    (or whole, as its layer, where the model axis does not divide the
    heads): what `registry.init_cache(mesh=)` allocates."""
    return _relaid(cache_shapes, mesh, cache_specs_tree(cache_shapes, mesh, batch_sharded),
                   _mamba_cache_layout)


def model_parts(spec, shape, mesh: Optional[MeshSpec]) -> tuple:
    """How a rank's slice, of `shape`, of a leaf laid out by `spec` lies on
    the model axis: (dim, ((local length, split), ...)), its blocks along
    `dim` in order, each this rank's block of one split over the axis
    (True) or whole on every rank (False). A leaf without a packed dim is
    one block along dim 0. What `optim.global_norm` counts by."""
    tp = tp_axis(mesh)
    for dim, ax in enumerate(spec):
        if isinstance(ax, Packed):
            return dim, tuple((n // axis_size(a, mesh), a == tp) for n, a in ax.blocks)
    return 0, ((shape[0], tp is not None and tp in spec),)


def specs_by_path(whole, mesh: Optional[MeshSpec]) -> dict:
    """{tree path: spec} of the whole params `whole` (one device's shapes,
    meta tensors will do) over `mesh` under `layout_specs`: what a rank's
    slices of them are cut and gathered by, whatever order a tree's dicts
    hold their keys in (`lay_over`)."""
    flat = pytree.tree_flatten_with_path(layout_specs(whole, mesh), is_leaf=_is_spec)[0]
    return {path_str(p): spec for p, spec in flat}


def lay_over(tree, by_path: dict):
    """A spec tree shaped like `tree` (a rank's slices), each leaf's spec
    looked up by its path in `specs_by_path`'s map."""
    return _map_with_path(lambda p, leaf: by_path[p], tree)


# ------------------------------------------------------------ local shards
def local_index(ax, mesh: MeshSpec) -> Optional[int]:
    """This rank's block along a spec entry: its coordinate on the axis,
    or on a tuple of axes their row-major combination (None when the mesh
    does not know this rank's coordinates)."""
    i = 0
    for a in ax if isinstance(ax, (tuple, list)) else (ax,):
        c = mesh.coordinate(a)
        if c is None:
            return None
        i = i * mesh.axis_size(a) + c
    return i


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def local_shape(shape, spec, mesh: Optional[MeshSpec]) -> tuple:
    """The shape of one rank's slice of a leaf of `shape` under `spec`."""
    out = list(shape)
    for dim, ax in enumerate(spec):
        out[dim] = ax.local_size(mesh) if isinstance(ax, Packed) else \
            out[dim] // axis_size(ax, mesh)
    return tuple(out)


def whole_shape(shape, spec, mesh: Optional[MeshSpec]) -> tuple:
    """The shape a rank's slice of `shape` under `spec` was cut from."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(ax.size if isinstance(ax, Packed) else n * axis_size(ax, mesh)
                 for n, ax in zip(shape, spec))


def _ranges(leaf, dim, ranges):
    """`leaf` (a tensor or a numpy array) cut to `ranges` of `dim`,
    concatenated in order."""
    index = [slice(None)] * len(leaf.shape)
    parts = []
    for lo, hi in ranges:
        index[dim] = slice(lo, hi)
        parts.append(leaf[tuple(index)])
    if len(parts) == 1:
        return parts[0]
    if isinstance(leaf, torch.Tensor):
        return torch.cat(parts, dim)
    return np.concatenate(parts, dim)


def local_shards(tree, specs, mesh: Optional[MeshSpec]):
    """This rank's slices of a full tree of tensors or numpy arrays under
    `specs` (`layout_specs`, `cache_layout`, ...): along each split dim
    the rank keeps its block (`local_index`), along a `Packed` one its
    blocks of the dim's blocks. A cut leaf is a contiguous copy, so the
    full one can be freed; a whole one is returned as it is. The mesh
    must know this rank's coordinates (bound, or `MeshSpec.as_rank`)."""
    leaves, treedef = pytree.tree_flatten(tree)
    spec_leaves = pytree.tree_leaves(specs, is_leaf=_is_spec)
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(spec_leaves)} specs")
    out = []
    for leaf, spec in zip(leaves, spec_leaves):
        cut = leaf
        for dim, ax in enumerate(spec):
            if isinstance(ax, Packed):
                cut = _ranges(cut, dim, ax.ranges(mesh))
                continue
            n = axis_size(ax, mesh)
            if n == 1:
                continue
            i, size = local_index(ax, mesh), leaf.shape[dim] // n
            if i is None:
                raise ValueError("local_shards needs this rank's coordinates: a bound mesh "
                                 "or MeshSpec.as_rank")
            cut = _ranges(cut, dim, [(i * size, (i + 1) * size)])
        if cut is not leaf:
            cut = cut.clone() if hasattr(cut, "clone") else cut.copy()
        out.append(cut)
    return pytree.tree_unflatten(out, treedef)


def local_zeros(whole, specs, mesh: Optional[MeshSpec], device):
    """Zeros of this rank's part of a tree of whole (meta) tensors under
    `specs`, on `device`: a cache allocated only where the rank holds it."""
    leaves, treedef = pytree.tree_flatten(whole)
    spec_leaves = pytree.tree_leaves(specs, is_leaf=_is_spec)
    return pytree.tree_unflatten(
        [torch.zeros(local_shape(a.shape, sp, mesh), dtype=a.dtype, device=device)
         for a, sp in zip(leaves, spec_leaves)], treedef)


# ------------------------------------------------------------ decode caches
def cache_specs_tree(cache_shapes, mesh: Optional[MeshSpec], batch_sharded: bool = True):
    """Specs for a decode cache tree (from registry.cache_specs).

    batch_sharded=True: shard the cache batch dim over the data axes (the
    decode_32k regime). batch_sharded=False (long_500k, global_batch=1):
    shard the KV *sequence* dim over the data axes instead (distributed
    flash-decode).
    """
    dp = dp_axes(mesh)
    b = dp if (batch_sharded and dp) else None
    s = None if batch_sharded else (dp or None)
    tp = tp_axis(mesh)

    def f(path, leaf):
        nd = len(leaf.shape)
        if path.endswith("conv"):
            spec = [b, None, tp]
        elif path.endswith("ssd"):
            spec = [b, tp, None, None]
        else:  # k / v KV caches: (batch, L, kv_heads, head_dim)
            spec = [b, s, tp, None]
        if nd < len(spec):
            spec = spec[-nd:] if nd else []
        return fit_spec([None] * (nd - len(spec)) + spec, leaf.shape, mesh)

    return _map_with_path(f, cache_shapes)


def batch_specs_tree(batch_shapes, mesh: Optional[MeshSpec]):
    """Specs for model inputs: batch dim on data axes, rest replicated."""
    b = dp_axes(mesh) or None

    def f(path, leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return ()
        return fit_spec([b] + [None] * (nd - 1), leaf.shape, mesh)

    return _map_with_path(f, batch_shapes)


def shard_bytes(leaf, spec, mesh: Optional[MeshSpec]) -> int:
    """Bytes of `leaf` that one device of `mesh` holds under `spec`."""
    return math.prod(local_shape(leaf.shape, spec, mesh)) * leaf.element_size()


# ------------------------------------------------------------ fleet mesh
def fleet_mesh(n_devices: Optional[int] = None) -> MeshSpec:
    """1-D mesh with axis ``"cells"`` for the compiled fleet pipeline
    (`repro_torch.fleet.compiled`): each rank runs the per-cell stages on
    its block of cells, and the tables replicate. It spans the first
    `n_devices` ranks of the process group (every rank by default), and
    every rank must call it; a rank outside it runs the fleet alone.
    Without a process group it is a one-device mesh, bound to nothing.
    ValueError when asked for more ranks than there are."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"asked for {n} mesh devices, have {world}")
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, not {n}")
    if world == 1:
        return MeshSpec(("cells",), (n,))
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(device_type, torch.arange(n), mesh_dim_names=("cells",))
    return MeshSpec(("cells",), (n,), device_mesh=dm)
