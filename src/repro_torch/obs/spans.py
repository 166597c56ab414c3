"""Named spans on the profiler's own clock, free when no profiler runs.

While a `torch.profiler.profile` (or the autograd profiler) is on,
`span(name)` is a profiler range of the function scope
(`torch._C._profiler._RecordFunctionFast`, as PyTorch's own compiled code
marks its calls), which Kineto puts on the host's timeline beside the ops
and the launches it holds. Otherwise it is one shared no-op context.

Why not `torch.profiler.record_function`: its user-scope ranges also get
a device-side copy, spread over the kernels they launched, which a reader
of the card's work that does not know each span's name (the benchmark's
`bench/benchkit/trace.py` on PyTorch 2.11) counts as busy time; entered
with no profiler on it costs about 10 µs a span, where the profiler's
flag, a module global, is read in well under one. A span takes no
arguments: Kineto's events do not carry a range's string argument, so a
batch is known by its rank among the ``engine.infer`` spans.

The served path carries these spans (`offload/engine.py`,
`models/transformer.py`):

* ``engine.infer``, tiled in timeline order by ``engine.edge``,
  ``engine.gate``, ``engine.select``, ``engine.codec`` (codec level not
  0), ``engine.cloud`` and ``engine.merge`` (refused rows only) and
  ``engine.fetch``;
* ``lm.mixer`` and ``lm.ffn`` once per block of a partition, ``lm.head``
  once per partition.
"""
from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
from torch._C import _profiler as _ranges

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` while a profiler is on, else a no-op."""
    if _profiler._is_profiler_enabled:
        return _ranges._RecordFunctionFast(name)
    return _OFF
