"""The plain reference of B-AlexNet: NCHW float32 PyTorch operations, read
from the configuration's table, with nothing of the port.

`forward` returns branch 1's logits for every row and the main head's for
the rows `final` marks. With ``precision`` other than float32 every
product's operands are rounded first (the control, `benchkit.precision`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchkit.precision import round_to

BLOCK_ROWS = 4096


def _pool(y):
    """3x3 / stride-2 max-pool with SAME padding: the pad split low = total // 2."""
    pads = []
    for size in (y.shape[3], y.shape[2]):
        out = -(-size // 2)
        total = max((out - 1) * 2 + 3 - size, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(y, pads, value=float("-inf")), 3, 2)


def _conv(x, p, pool, r):
    k = p["w"].shape[-1]
    y = torch.relu(F.conv2d(r(x), r(p["w"]), p["b"], padding=k // 2))
    return _pool(y) if pool else y


def _fc(x, p, r):
    return r(x) @ r(p["w"]) + p["b"]


def _flat(x):
    """NCHW to rows in NHWC order, the order of the dense weights' rows."""
    return x.permute(0, 2, 3, 1).flatten(1)


def _block(w, spec, images, final, r):
    pools = {l["name"]: l.get("pool", False) for l in spec["layers"]}
    x = _conv(images.permute(0, 3, 1, 2).contiguous(), w["conv1"], pools["conv1"], r)
    b = w["branch1"]
    exit_logits = _fc(_flat(_conv(x, b["conv"], spec["branch1"]["conv"]["pool"], r)), b["fc"], r)
    x = x[final]
    for name in ("conv2", "conv3", "conv4", "conv5"):
        x = _conv(x, w[name], pools[name], r)
    x = _flat(x)
    x = torch.relu(_fc(x, w["fc1"], r))
    x = torch.relu(_fc(x, w["fc2"], r))
    return exit_logits, _fc(x, w["fc3"], r)


def forward(weights, spec, inputs, final, precision="float32"):
    """(branch-1 logits (n, 10), main-head logits (final.sum(), 10)), float32."""
    def r(x):
        return round_to(x, precision)

    images = inputs["images"].to(torch.float32)
    exits, finals = [], []
    with torch.no_grad():
        for i in range(0, images.shape[0], BLOCK_ROWS):
            e, f = _block(weights, spec, images[i:i + BLOCK_ROWS], final[i:i + BLOCK_ROWS], r)
            exits.append(e)
            finals.append(f)
    return torch.cat(exits), torch.cat(finals)
