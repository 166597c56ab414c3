"""Checkpointing: msgpack-serialized parameter trees with dtype and shape
fidelity (port of `repro.training.checkpoint`, in its file format).

A file holds ``{"leaves": [...], "n": count}``; a bfloat16 leaf is
``{b"__bf16__": True, b"data": uint16 bytes, b"shape": [...]}`` and any
other ``{b"__nd__": True, b"dtype": numpy dtype string, b"data", b"shape"}``.
The leaves are in JAX's flattening order: dict keys sorted, lists and
tuples (an `OptState` too) in order, None holding no leaf. So a file
written by either package loads in the other. `load` validates the leaf
count and every shape against a template, so a config drift fails
loudly; `save` writes a temp file and renames it over the target.

Over a mesh (``mesh`` and ``specs``: a tree of this rank's slices and
the specs it was cut by, `sharding.lay_over`) the file is still one
device's: `save` gathers each split leaf whole as it writes it, one leaf
on the host at a time (`launch.mesh.gather_whole`; every rank takes
part), and the rank at the mesh's origin writes it; `load` reads the
whole leaves and keeps this rank's slice of each
(`sharding.local_shards`), leaf by leaf.
"""
from __future__ import annotations

import os
import tempfile

import msgpack
import numpy as np
import torch

from repro_torch import sharding
from repro_torch.launch.mesh import gather_whole


def _flatten(tree):
    """Leaves in JAX's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _unflatten(template, leaves):
    """`template`'s structure with its leaves replaced, in `_flatten`'s order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: None for k in node}  # the template's key order
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if isinstance(node, (list, tuple)):
            vals = [build(v) for v in node]
            if isinstance(node, list):
                return vals
            return type(node)(*vals) if hasattr(node, "_fields") else tuple(vals)
        return next(it)

    return build(template)


def _encode(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {b"__bf16__": True, b"data": t.view(torch.int16).numpy().tobytes(),
                    b"shape": list(t.shape)}
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return {b"__nd__": True, b"dtype": a.dtype.str, b"data": a.tobytes(),
            b"shape": list(a.shape)}


def _decode(obj, device):
    if b"__bf16__" in obj:
        a = np.frombuffer(obj[b"data"], np.int16).reshape(obj[b"shape"])
        return torch.from_numpy(a.copy()).view(torch.bfloat16).to(device)
    a = np.frombuffer(obj[b"data"], np.dtype(obj[b"dtype"])).reshape(obj[b"shape"])
    return torch.from_numpy(a.copy()).to(device)


def _with_specs(tree, specs):
    """(leaf, spec) pairs of `tree` and of the `specs` tree laid over it,
    in `_flatten`'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _with_specs(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [p for v, s in zip(tree, specs) for p in _with_specs(v, s)]
    return [(tree, specs)]


def save(path: str, tree, mesh=None, specs=None) -> None:
    """Write `tree`, leaf by leaf; with `mesh` and `specs`, each leaf
    gathered whole from the ranks' slices as it is written, by the rank at
    the mesh's origin (every rank takes part in each gather)."""
    if mesh is None:
        leaves = _flatten(tree)
    else:
        pairs = _with_specs(tree, specs)
        leaves = (gather_whole([leaf], [spec], mesh)[0] for leaf, spec in pairs)
        if any(mesh.coordinate(a) for a in mesh.axis_names):
            for _ in leaves:  # this rank's part of each gather
                pass
            return
    packer = msgpack.Packer(use_bin_type=True)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d)
    with os.fdopen(fd, "wb") as f:
        # msgpack.packb({"leaves": [...], "n": n}), one leaf at a time
        f.write(packer.pack_map_header(2) + packer.pack("leaves")
                + packer.pack_array_header(len(_flatten(tree))))
        for leaf in leaves:
            f.write(packer.pack(_encode(leaf)))
        f.write(packer.pack("n") + packer.pack(len(_flatten(tree))))
    os.replace(tmp, path)


def load(path: str, template, mesh=None, specs=None):
    """Restore into the structure of `template` (leaf count and shapes
    validated). Each leaf lands on its template leaf's device (the CPU
    where the template leaf is not a tensor). With `mesh` and `specs` the
    template is this rank's slices: each whole leaf of the file is checked
    against the shape it was cut from, and this rank keeps its slice of
    it, leaf by leaf. The file is read as it is decoded: one encoded leaf
    is in memory at a time."""
    pairs = ([(t, None) for t in _flatten(template)] if mesh is None
             else _with_specs(template, specs))
    leaves = []
    with open(path, "rb") as f:
        unpacker = msgpack.Unpacker(f, raw=True, max_buffer_size=2 ** 40)
        for _ in range(unpacker.read_map_header()):
            if unpacker.unpack() != b"leaves":
                unpacker.skip()
                continue
            n = unpacker.read_array_header()
            if n != len(pairs):
                raise ValueError(f"checkpoint has {n} leaves, template {len(pairs)}")
            for want, spec in pairs:
                on = want.device if isinstance(want, torch.Tensor) else "cpu"
                got = _decode(unpacker.unpack(), on if spec is None else "cpu")
                shape = (tuple(np.shape(want)) if spec is None
                         else sharding.whole_shape(want.shape, spec, mesh))
                if tuple(got.shape) != shape:
                    raise ValueError(f"shape mismatch: {tuple(got.shape)} vs {shape}")
                if spec is not None:
                    got = sharding.local_shards([got], [spec], mesh)[0].to(on)
                leaves.append(got)
    if len(leaves) != len(pairs):
        raise ValueError(f"checkpoint has no leaves, template {len(pairs)}")
    return _unflatten(template, leaves)
