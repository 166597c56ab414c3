"""The frozen FLOP count of B-AlexNet split at branch 1: what the algorithm
needs per image, 2 per multiply-add of every convolution and dense product
(biases, activations and pooling count 0, as in a dry run's
`FlopCounterMode`)."""
from __future__ import annotations


def _conv(c, size):
    return 2 * size * size * c["cout"] * c["cin"] * c["k"] * c["k"]


def _fc(c):
    return 2 * c["din"] * c["dout"]


def per_row(spec: dict, workload: dict):
    """(edge FLOPs, cloud FLOPs) for one image."""
    size = spec["image"][0]
    edge = cloud = 0
    for layer in spec["layers"]:
        if layer["kind"] == "conv":
            flops = _conv(layer, size)
            size = -(-size // 2) if layer["pool"] else size
        else:
            flops = _fc(layer)
        if layer["name"] == "conv1":
            edge += flops
            b = spec["branch1"]
            edge += _conv(b["conv"], size) + _fc(b["fc"])
        else:
            cloud += flops
    return edge, cloud
