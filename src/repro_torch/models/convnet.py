"""B-AlexNet: the paper's own experimental vehicle (port of
`repro.models.convnet`).

AlexNet adapted to 32x32 inputs with BranchyNet-style early-exit side
branches: branch 1 after the first ReLU (the paper's default single-branch
setup, Fig. 1), branch 2 after the second ReLU (Sec. IV-F). The edge runs
conv1 (+ branch); the cloud runs the rest.

The public functions keep the reference's layouts: NHWC images in, an
NHWC-contiguous payload out (the codec groups 128 consecutive features of
a sample, so the payload layout is part of the wire format), and dense
weights (din, dout) whose rows follow the NHWC flatten order. Inside,
convolutions run on an NCHW view of the NHWC data (PyTorch's channels-last
format), with conv weights stored OIHW. `params_from_jax` carries a
reference parameter tree across.

Padding follows the reference's "SAME": symmetric for the odd conv
kernels, and 0 before / 1 after for the 3x3 stride-2 max-pool on even
sizes (`F.max_pool2d(padding=1)` would pad both sides and shift every
window).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import as_tensor, resolve_device
from repro_torch.configs.base import ModelConfig

# (name, kind, spec) in execution order; exits attach after relu1 / relu2.
LAYER_TABLE = [
    ("conv1", "conv", dict(cin=3, cout=64, k=5, pool=True)),
    ("conv2", "conv", dict(cin=64, cout=96, k=5, pool=True)),
    ("conv3", "conv", dict(cin=96, cout=192, k=3, pool=False)),
    ("conv4", "conv", dict(cin=192, cout=128, k=3, pool=False)),
    ("conv5", "conv", dict(cin=128, cout=128, k=3, pool=True)),
    ("fc1", "fc", dict(din=128 * 4 * 4, dout=256)),
    ("fc2", "fc", dict(din=256, dout=128)),
    ("fc3", "fc", dict(din=128, dout=10)),
]

B_ALEXNET = ModelConfig(
    name="b_alexnet",
    family="convnet",
    num_layers=8,
    d_model=0,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=10,
    head_dim=1,
    use_rope=False,
    exit_layers=(0, 1),  # after conv1-relu / conv2-relu
    exit_loss_weights=(1.0, 1.0),
    dtype="float32",
    source="BranchyNet AlexNet on CIFAR-10 [Teerapittayanon+ 2016; paper Sec. III]",
)


def _conv_init(gen, device, cin, cout, k):
    w = torch.randn((cout, cin, k, k), generator=gen, device=device) * (k * k * cin) ** -0.5
    return {"w": w, "b": torch.zeros(cout, device=device)}


def _fc_init(gen, device, din, dout):
    w = torch.randn((din, dout), generator=gen, device=device) * din ** -0.5
    return {"w": w, "b": torch.zeros(dout, device=device)}


def init_params(generator: torch.Generator = None, device=None, cfg: ModelConfig = B_ALEXNET):
    """Random B-AlexNet parameters with the reference's distribution:
    N(0, 1/fan_in) weights, zero biases. `generator` must live on
    `device` (``cuda`` by default); None seeds a fresh one with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = {}
    for name, kind, spec in LAYER_TABLE:
        if kind == "conv":
            params[name] = _conv_init(generator, device, spec["cin"], spec["cout"], spec["k"])
        else:
            params[name] = _fc_init(generator, device, spec["din"], spec["dout"])
    # side branches: small conv + fc head (BranchyNet recipe)
    params["branch1"] = {
        "conv": _conv_init(generator, device, 64, 32, 3),
        "fc": _fc_init(generator, device, 32 * 8 * 8, 10),
    }
    params["branch2"] = {
        "conv": _conv_init(generator, device, 96, 32, 3),
        "fc": _fc_init(generator, device, 32 * 4 * 4, 10),
    }
    return params


def params_from_jax(tree, device=None):
    """Carry a reference parameter tree (nested dicts of arrays) across:
    conv kernels HWIO -> OIHW, everything else (dense (din, dout), biases)
    as it is. Lands on `device` (``cuda`` by default)."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        t = torch.as_tensor(np.array(node, dtype=np.float32))
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1)
        return t.contiguous().to(device)

    return convert(tree)


def _nchw(x):
    """NCHW view of NHWC data (no copy: channels-last strides)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    """NHWC-contiguous tensor of NCHW data (no copy when already channels-last)."""
    return x.permute(0, 2, 3, 1).contiguous()


def _max_pool_same(y):
    """3x3 / stride-2 max-pool with XLA's "SAME" padding (pad_lo = total // 2)."""
    pads = []
    for size in (y.shape[3], y.shape[2]):  # F.pad lists the last dim first
        total = max((-(-size // 2) - 1) * 2 + 3 - size, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(y, pads, value=float("-inf")), 3, 2)


def _conv(p, x, pool):
    w = p["w"]
    y = F.relu(F.conv2d(x, w, p["b"], padding=w.shape[-1] // 2))
    return _max_pool_same(y) if pool else y


def _flatten(x):
    """Flatten in NHWC order, as the reference's reshape does."""
    return _nhwc(x).reshape(x.shape[0], -1)


def _branch(p, x):
    y = _conv(p["conv"], x, pool=True)
    return _flatten(y) @ p["fc"]["w"] + p["fc"]["b"]


def _head(params, x):
    x = _conv(params["conv3"], x, pool=False)
    x = _conv(params["conv4"], x, pool=False)
    x = _conv(params["conv5"], x, pool=True)  # (b,128,4,4)
    x = F.relu(_flatten(x) @ params["fc1"]["w"] + params["fc1"]["b"])
    x = F.relu(x @ params["fc2"]["w"] + params["fc2"]["b"])
    return x @ params["fc3"]["w"] + params["fc3"]["b"]


def forward(params, images, num_branches: int = 2):
    """images: (b, 32, 32, 3) NHWC. Returns {exit_logits: [...], logits}."""
    x = _conv(params["conv1"], _nchw(as_tensor(images)), pool=True)  # (b,64,16,16)
    exit_logits = []
    if num_branches >= 1:
        exit_logits.append(_branch(params["branch1"], x))
    x = _conv(params["conv2"], x, pool=True)  # (b,96,8,8)
    if num_branches >= 2:
        exit_logits.append(_branch(params["branch2"], x))
    return {"exit_logits": exit_logits, "logits": _head(params, x)}


def edge_forward(params, images, branch: int = 1):
    """Edge partition: layers up to branch `branch` + that branch head.

    Returns (branch_logits, payload): the payload is the NHWC-contiguous
    intermediate activation the paper sends over the 18.8 Mbps uplink.
    """
    x = _conv(params["conv1"], _nchw(as_tensor(images)), pool=True)
    if branch == 1:
        return _branch(params["branch1"], x), _nhwc(x)
    x = _conv(params["conv2"], x, pool=True)
    return _branch(params["branch2"], x), _nhwc(x)


def cloud_forward(params, hidden, from_branch: int = 1):
    """Cloud partition: remaining layers after branch `from_branch`;
    `hidden` is the NHWC payload."""
    x = _nchw(as_tensor(hidden))
    if from_branch == 1:
        x = _conv(params["conv2"], x, pool=True)
    return _head(params, x)


def payload_bytes(branch: int = 1) -> int:
    """Size of the edge->cloud activation (float32), per sample."""
    if branch == 1:
        return 16 * 16 * 64 * 4
    return 8 * 8 * 96 * 4
