"""Deprecation shim: the batched fleet gate moved into the control plane.

`FleetGateTable` grew into the repo-wide dense gate table and now lives
in `repro_torch.core.gatepath` as `GateTable`, where it routes both its
precompute and its window lookups through the selectable `GateBackend`
(host numpy or the card). Importing ANY name from this module emits a
`DeprecationWarning`; new code should import `repro_torch.core.gatepath`
directly (or `repro_torch.fleet.FleetGateTable`, which re-exports the
same class warning-free). The shim resolves lazily (PEP 562) so merely
importing `repro_torch.fleet` stays silent.

Port of `repro.fleet.gate`. The reference's ``JaxGateBackend`` name maps
onto the port's ``TorchGateBackend``, the backend that took its place.
"""
from __future__ import annotations

import warnings

from repro_torch.core import gatepath as _gatepath

#: Every name this module re-exports, with the `repro_torch.core.gatepath`
#: name it resolves to (`FleetGateTable` is the deprecated alias of
#: `GateTable` -- the class itself, so isinstance checks keep working).
_SHIMMED = {
    "FleetGateTable": "GateTable",
    "GateBackend": "GateBackend",
    "GateTable": "GateTable",
    "JaxGateBackend": "TorchGateBackend",
    "NumpyGateBackend": "NumpyGateBackend",
    "STATIC_CONTEXT": "STATIC_CONTEXT",
    "get_gate_backend": "get_gate_backend",
}


def __getattr__(name: str):
    if name in _SHIMMED:
        target = _SHIMMED[name]
        warnings.warn(
            f"repro_torch.fleet.gate.{name} is deprecated; import "
            f"repro_torch.core.gatepath.{target} instead",
            DeprecationWarning,
            stacklevel=2,
        )
        return getattr(_gatepath, target)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SHIMMED))
