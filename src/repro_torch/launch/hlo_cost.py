"""The step cost model of the dry run (counterpart of
`repro.launch.hlo_cost`; the name is kept so that a reader finds it).

There is no HLO on this path. The reference costs the optimized HLO of a
compiled step; the port runs the step eagerly, so `analyze` traces one
call of it on fake tensors (`FakeTensorMode`: shapes and dtypes, no
storage, no kernel launched) and costs what ran:

  flops  from `torch.utils.flop_counter.FlopCounterMode`: matrix products
         and convolutions, forward and backward, the recomputation of
         checkpointed layers included, and the custom ops of K1 and K2 at
         their registered per-logit formulas (`kernels.exit_gate`,
         `kernels.calib_nll`). Elementwise work counts 0, as in the
         reference's model, which counts dots and reduce-windows.
  bytes  the unfused upper bound: every op reads each tensor input once
         and writes each output once, summed by a `TorchDispatchMode`.
         Views (reshape, transpose, slices, expand) move nothing. A custom
         kernel op is one op, counted at its own inputs and outputs. This
         plays the part of the reference's fusion-boundary model for XLA:
         eager PyTorch runs every op as its own kernel, so it is the bytes
         such a step moves when no op is fused.
  peak_bytes  the most bytes of tensor storage alive at once during the
         call, inputs included (`LiveBytes`).

  collective_bytes, collective_counts  per kind (the reference's
         `COLLECTIVES` names), the operand bytes and the count of every
         collective the step issues (`launch.mesh.record_collectives`):
         what it launches, so `launch.mesh.gather_blocks` is an
         ``all-reduce`` of its W-block buffer. Empty for a step on one card.
         Traced as one rank of a described mesh (`MeshSpec.as_rank`) the
         step issues nothing and each collective is only recorded.
  collective_passes  the same split by the pass that issued them
         (forward, backward, a checkpointed layer's recompute).
"""
from __future__ import annotations

import weakref

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.launch.mesh import record_collectives

# the reference's collective kinds (repro.launch.hlo_cost.COLLECTIVES)
COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


# ops that return a view of their input in all but the schema's name
_NOT_MOVED = {torch.ops.aten._unsafe_view.default, torch.ops.aten.lift_fresh.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


class OpBytes(TorchDispatchMode):
    """Sums, over every op that is not a view, the bytes of its tensor
    inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _NOT_MOVED:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)) + _tensors(out))
        return out


class LiveBytes(TorchDispatchMode):
    """Peak bytes of tensor storage alive at once.

    Each storage is counted once, from the op that made it (or from
    `track`, for the inputs) until the last tensor on it is gone, which a
    weak reference to the storage reports: the method of
    `torch.distributed._tools.mem_tracker`, without the allocator's
    rounding. Works the same on fake and on real tensors.
    """

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def _free(self, n):
        self.live -= n

    def track(self, tree) -> None:
        for t in _tensors(tree):
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = weakref.ref(st, lambda _ref, n=n: self._free(n))
            self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.track(out)
        return out


def analyze(step, *args, **kwargs):
    """Trace `step(*args, **kwargs)` once and cost it.

    The tensors in `args` should be fake (made under a `FakeTensorMode`
    that is active around this call), so that nothing is allocated and no
    kernel runs. Returns the reference's keys (``flops``, ``bytes``,
    ``collective_bytes``, ``collective_counts``) and ``peak_bytes``, all
    of one rank when the step runs over a mesh.
    """
    live = LiveBytes()
    live.track((args, kwargs))
    with record_collectives() as log, FlopCounterMode(display=False) as flops, \
            OpBytes() as moved, live:
        step(*args, **kwargs)
    assert set(log.counts) <= set(COLLECTIVES), dict(log.counts)
    return {"flops": int(flops.get_total_flops()), "bytes": int(moved.bytes),
            "collective_bytes": dict(log.bytes), "collective_counts": dict(log.counts),
            "collective_passes": log.by_pass(),
            "peak_bytes": int(live.peak)}
