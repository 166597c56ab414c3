"""Faults planted under the timed path, each of which the comparison has to
read as not correct: wrappers of `OffloadEngine.infer`, by name.

* ``answer_altered``: the first row's prediction of every batch moved to
  a neighbouring class, where the engine produces it;
* ``half_left_out``: the second half of every batch left out, its answers
  copied from the first half.
"""
from __future__ import annotations

import numpy as np


def answer_altered(infer):
    def broken(self, batch):
        out = infer(self, batch)
        pred = out["prediction"].copy()
        pred[0] = pred[0] - 1 if pred[0] > 0 else 1
        return dict(out, prediction=pred)
    return broken


def half_left_out(infer):
    def broken(self, batch):
        out = infer(self, batch)
        half = len(out["prediction"]) // 2
        return {k: np.concatenate([v[:half], v[:len(v) - half]]) for k, v in out.items()}
    return broken


FAULTS = {"answer_altered": answer_altered, "half_left_out": half_left_out}


def plant(name: str):
    """Put fault `name` under `OffloadEngine.infer`; returns the undo."""
    from repro_torch.offload.engine import OffloadEngine

    original = OffloadEngine.infer
    OffloadEngine.infer = FAULTS[name](original)

    def undo():
        OffloadEngine.infer = original
    return undo
