"""The comparison's numbers on hand-made rows: each route's confidence is
held to its own limit, and a route is judged only outside the exit's
margin around p_tar."""
import math

import pytest
import torch

from benchkit import judge

LIMITS = {"t_rel": 1e-6, "conf_exit_rel": 1e-3, "conf_final_rel": 1e-1, "logit_gap": 1e-4,
          "route_flips": 0}


def _rows(exit_logits, final_logits, on, pred=None):
    """The port's answers as the reference would give them."""
    on = torch.tensor(on)
    z = exit_logits.clone()
    z[~on] = final_logits
    conf = torch.where(on, judge.confidence(exit_logits), judge.confidence(z))
    return {"prediction": z.argmax(-1) if pred is None else torch.tensor(pred),
            "confidence": conf, "on_device": on}


def _logits(margins):
    """Two-class rows whose top softmax is sigmoid(margin)."""
    m = torch.tensor(margins, dtype=torch.float64)
    return torch.stack([m, torch.zeros_like(m)], dim=-1)


def test_routes_held_to_their_own_limits():
    ex, fin = _logits([2.0, 0.5]), _logits([1.0])
    port = _rows(ex, fin, [True, False])
    port["confidence"] = port["confidence"] * torch.tensor([1.0, 1.05], dtype=torch.float64)
    numbers, counts = judge.compare(port, ex, fin, 1.0, 1.0, 0.7, LIMITS)
    assert numbers["conf_exit_rel"] == 0.0
    assert numbers["conf_final_rel"] == pytest.approx(0.05)
    assert counts["bad"] == 0
    port["confidence"][0] *= 1.01
    numbers, counts = judge.compare(port, ex, fin, 1.0, 1.0, 0.7, LIMITS)
    assert numbers["conf_exit_rel"] == pytest.approx(0.01) and counts["bad"] == 1


@pytest.mark.parametrize("shift, flips", [(1e-5, 0), (1e-2, 1)])
def test_route_flip_outside_the_margin_only(shift, flips):
    p_tar = 0.7
    margin = math.log(p_tar / (1 - p_tar))
    ex = _logits([margin + shift, 3.0])  # the first row just above p_tar
    fin = _logits([1.0])
    port = _rows(ex, fin, [True, True])
    port["on_device"] = torch.tensor([False, True])  # the first row refused all the same
    port["confidence"] = torch.stack([judge.confidence(fin)[0], port["confidence"][1]])
    numbers, counts = judge.compare(port, ex, _logits([1.0]), 1.0, 1.0, p_tar, LIMITS)
    assert numbers["route_flips"] == flips
    assert counts["judged"] == 1 + flips
