"""B-AlexNet under the benchmark: its weights and images made on the card
from the seed, and the port's engine over them (`convnet_engine`, split at
the configuration's branch).

The weights are the benchmark's: one float32 draw for every leaf, each
leaf a view of it scaled to N(0, 1/fan_in). The same tree goes to the port
and to the plain reference (`reference.py`).
"""
from __future__ import annotations

import torch

#: bytes of one exit logit as the gate (K1) reads it
LOGIT_BYTES = 4
#: rows the reference takes in one call of the check
CHECK_ROWS = 65536


def spec(config: dict, smoke: bool = False) -> dict:
    """The sizes as run. B-AlexNet has no width to cut: smoke runs only take
    smaller batches (the workload's ``smoke`` block)."""
    out = dict(config)
    out.update(config.get("smoke", {}) if smoke else {})
    return out


def _leaves(spec):
    """(path, shape, std) of every weight the branch-1 split reads."""
    bias = spec["init"]["bias_std"]

    def conv(path, c):
        fan = c["k"] * c["k"] * c["cin"]
        return [(path + ("w",), (c["cout"], c["cin"], c["k"], c["k"]), fan ** -0.5),
                (path + ("b",), (c["cout"],), bias)]

    def fc(path, c):
        return [(path + ("w",), (c["din"], c["dout"]), c["din"] ** -0.5),
                (path + ("b",), (c["dout"],), bias)]

    out = []
    for layer in spec["layers"]:
        out += (conv if layer["kind"] == "conv" else fc)((layer["name"],), layer)
    b = spec["branch1"]
    return out + conv(("branch1", "conv"), b["conv"]) + fc(("branch1", "fc"), b["fc"])


def make_weights(gen: torch.Generator, spec: dict, device) -> dict:
    leaves = _leaves(spec)
    sizes = [torch.Size(shape).numel() for _, shape, _ in leaves]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device).normal_(generator=gen)
    tree: dict = {}
    for (path, shape, std), w in zip(leaves, torch.split(flat, sizes)):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = w.view(shape).mul_(std)
    return tree


def _smooth(f, passes):
    for dim in (1, 2):
        for _ in range(passes):
            f = 0.5 * f + 0.25 * (torch.roll(f, 1, dim) + torch.roll(f, -1, dim))
    return f


def make_data(gen: torch.Generator, spec: dict, device) -> dict:
    """The class templates of the cifar_like recipe: smooth fields of RMS 1."""
    h, w, c = spec["image"]
    t = torch.randn((spec["classes"], h, w, c), generator=gen, device=device)
    t = _smooth(t, spec["data"]["smooth"])
    return {"templates": t / t.square().mean(dim=(1, 2, 3), keepdim=True).sqrt()}


def draw(state: dict, gen: torch.Generator, n: int, workload: dict, spec: dict) -> dict:
    """n NHWC images: easy ones a template plus noise, hard ones a mix of two
    templates with weight alpha in [mix_low, mix_high] plus noise."""
    t, d = state["templates"], spec["data"]
    dev, k = t.device, t.shape[0]
    ya = torch.randint(0, k, (n,), generator=gen, device=dev)
    yb = (ya + torch.randint(1, k, (n,), generator=gen, device=dev)) % k
    easy = torch.rand(n, generator=gen, device=dev) < d["easy_frac"]
    mix = d["mix_low"] + (d["mix_high"] - d["mix_low"]) * torch.rand(n, generator=gen, device=dev)
    alpha = torch.where(easy, torch.ones_like(mix), mix)[:, None, None, None]
    noise = torch.randn((n,) + t.shape[1:], generator=gen, device=dev)
    return {"images": alpha * t[ya] + (1 - alpha) * t[yb] + d["noise"] * noise}


def plan_index(spec: dict) -> int:
    """The plan's calibrator index of the deployed exit."""
    return spec["branch"] - 1


def rows(inputs: dict, index) -> dict:
    return {"images": inputs["images"][index]}


def engine(weights: dict, spec: dict, plan, workload: dict, device):
    """The port's engine: B-AlexNet split at branch `spec["branch"]`."""
    from repro_torch.models.convnet import LAYER_TABLE
    from repro_torch.offload.engine import convnet_engine

    ported = [(n, k, dict(s)) for n, k, s in LAYER_TABLE]
    ours = [(l["name"], l["kind"], {k: v for k, v in l.items() if k not in ("name", "kind")})
            for l in spec["layers"]]
    if ported != ours:
        raise ValueError(f"the port's LAYER_TABLE {ported} is not the configuration's {ours}")
    return convnet_engine(weights, plan, branch=spec["branch"], device=device)
