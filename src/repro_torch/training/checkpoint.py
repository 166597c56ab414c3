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
"""
from __future__ import annotations

import os
import tempfile

import msgpack
import numpy as np
import torch


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


def save(path: str, tree) -> None:
    leaves = _flatten(tree)
    payload = msgpack.packb({"leaves": [_encode(l) for l in leaves], "n": len(leaves)},
                            use_bin_type=True)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d)
    with os.fdopen(fd, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


def load(path: str, template):
    """Restore into the structure of `template` (leaf count and shapes
    validated). Each leaf lands on its template leaf's device (the CPU
    where the template leaf is not a tensor)."""
    with open(path, "rb") as f:
        obj = msgpack.unpackb(f.read(), raw=True)
    t_leaves = _flatten(template)
    if len(obj[b"leaves"]) != len(t_leaves):
        raise ValueError(f"checkpoint has {len(obj[b'leaves'])} leaves, template {len(t_leaves)}")
    leaves = []
    for enc, want in zip(obj[b"leaves"], t_leaves):
        got = _decode(enc, want.device if isinstance(want, torch.Tensor) else "cpu")
        if tuple(got.shape) != tuple(np.shape(want)):
            raise ValueError(f"shape mismatch: {tuple(got.shape)} vs {tuple(np.shape(want))}")
        leaves.append(got)
    return _unflatten(template, leaves)
