"""Described device meshes (counterpart of `repro.launch.mesh`).

The reference builds TPU v5e meshes of real devices: one pod of 256 chips
as (data=16, model=16), or two pods, 512 chips, as (pod=2, data=16,
model=16), where the pod axis carries data parallelism only. One H100 has
no such mesh, and this port runs every step on one card. A `MeshSpec`
describes a mesh instead, by its axis names and sizes, and needs no
device: `repro_torch.sharding` reads it to lay out the specs of every
parameter, cache and batch leaf, and `launch.dryrun` divides each leaf's
bytes by the product of the mesh axes that shard it, to give the bytes
one card of such a mesh would hold.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis names and sizes, in order; no devices behind it."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

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


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's production layout: (data=16, model=16), or with
    `multi_pod` (pod=2, data=16, model=16)."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_debug_mesh(data: int = 1, model: int = 1) -> MeshSpec:
    """A (data, model) mesh of any size, for tests and `dryrun --mesh`."""
    return MeshSpec(("data", "model"), (data, model))
