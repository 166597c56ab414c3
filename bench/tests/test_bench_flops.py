"""The frozen FLOP counts against the dry run's count of what the port
executes (`launch.hlo_cost.analyze`, `FlopCounterMode`), at the published
widths on meta tensors (shapes only): equal for all of B-AlexNet, and for
Qwen3's projections, MLP and heads, where the port computes the full
score matrices that the causal algorithm halves."""
import pytest
import torch

from benchkit.manifest import Manifest


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _count(fn, *args):
    from repro_torch.launch.hlo_cost import analyze

    out = {}

    def step(*a):
        out["value"] = fn(*a)

    return analyze(step, *args)["flops"], out["value"]


def test_b_alexnet(root):
    from repro_torch.models import convnet

    cell = Manifest(root).cell("b_alexnet.br1-offload-half")
    model, flops = cell.module("model"), cell.module("flops")
    spec = model.spec(cell.config)
    w = model.make_weights(torch.Generator().manual_seed(0), spec, "cpu")
    b, m = 6, 4
    images = torch.empty((b, 32, 32, 3), device="meta")
    edge, (_, hidden) = _count(lambda p, x: convnet.edge_forward(p, x, branch=1), _meta(w), images)
    cloud, _ = _count(lambda p, h: convnet.cloud_forward(p, h, from_branch=1), _meta(w),
                      torch.empty((m,) + tuple(hidden.shape[1:]), device="meta"))
    per_edge, per_cloud = flops.per_row(spec, {})
    assert (edge, cloud) == (b * per_edge, m * per_cloud)
    assert (per_edge, per_cloud) == (19_308_544, 148_179_456)


@pytest.mark.parametrize("seq_len", [64, 512])
def test_qwen3_8b(root, seq_len):
    from repro_torch.models import transformer

    cell = Manifest(root).cell("qwen3-8b.exit0-s512-offload-half")
    model, flops = cell.module("model"), cell.module("flops")
    spec = model.spec(cell.config)
    shapes = {name: torch.empty(shape, dtype=dtype, device="meta")
              for name, shape, dtype, _ in model._leaves(spec)}
    cfg = model.port_config(spec)
    params = model.port_params(shapes, cfg)
    params["exits"][0] = {"norm": {"scale": shapes["exit_norm"]},
                          "head": {"w": shapes["exit_head"]}}
    b, m = 2, 1
    tokens = torch.empty((b, seq_len), dtype=torch.int64, device="meta")
    edge, out = _count(lambda p, t: transformer.edge_forward(p, cfg, {"tokens": t}), params, tokens)
    cloud, _ = _count(lambda p, h: transformer.cloud_forward(p, cfg, h), params,
                      torch.empty((m, seq_len, spec["hidden_size"]), dtype=torch.bfloat16,
                                  device="meta"))
    work = {"seq_len": seq_len}
    per_edge, per_cloud = flops.per_row(spec, work)
    attn_edge, attn_cloud = flops.attention_per_row(spec, work)
    full = 4 * spec["num_attention_heads"] * spec["head_dim"] * seq_len ** 2  # a layer, a row
    edge_layers = spec["exit_layer"] + 1
    cloud_layers = spec["num_hidden_layers"] - edge_layers
    assert edge - b * edge_layers * full == b * (per_edge - attn_edge)
    assert cloud - m * cloud_layers * full == m * (per_cloud - attn_cloud)
