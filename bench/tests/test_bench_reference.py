"""Each plain reference computes what the port computes, on the CPU: B-AlexNet
at its full width, Qwen3 at the configuration's smoke size in float32,
both on the benchmark's own seeded weights and inputs."""
import pytest
import torch

from benchkit import seeds
from benchkit.manifest import Manifest

SEED = 2**31 + 101


def _cell(root, name):
    cell = Manifest(root).cell(name)
    return cell, cell.module("model"), cell.module("reference")


def test_b_alexnet(root):
    from repro_torch.models import convnet

    cell, model, reference = _cell(root, "b_alexnet.br1-offload-half")
    spec = model.spec(cell.config)
    w = model.make_weights(seeds.generator(SEED, "weights", device="cpu"), spec, "cpu")
    state = model.make_data(seeds.generator(SEED, "data", device="cpu"), spec, "cpu")
    images = model.draw(state, seeds.generator(SEED, "window", device="cpu"), 16, {}, spec)
    final = torch.arange(16) % 3 != 0
    exit_ref, final_ref = reference.forward(w, spec, images, final)
    with torch.no_grad():
        exit_port, hidden = convnet.edge_forward(w, images["images"], branch=1)
        final_port = convnet.cloud_forward(w, hidden[final], from_branch=1)
    torch.testing.assert_close(exit_port, exit_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(final_port, final_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("exit_index", [0, 1])
def test_qwen3_float32(root, exit_index):
    from repro_torch.models import transformer

    cell, model, reference = _cell(root, "qwen3-8b.exit0-s512-offload-half")
    spec = model.spec(dict(cell.config, exit_index=exit_index), smoke=True)
    w = model.make_weights(seeds.generator(SEED, "weights", device="cpu"), spec, "cpu")
    w = {k: v.float() for k, v in w.items()}
    cfg = model.port_config(dict(spec, dtype="float32"))
    params = model.port_params(w, cfg)
    params["exits"][exit_index] = {"norm": {"scale": w["exit_norm"]}, "head": {"w": w["exit_head"]}}
    tokens = model.draw(None, seeds.generator(SEED, "window", device="cpu"), 5,
                        {"seq_len": 12}, spec)
    final = torch.tensor([True, False, True, True, False])
    exit_ref, final_ref = reference.forward(w, spec, tokens, final)
    with torch.no_grad():
        edge = transformer.edge_forward(params, cfg, tokens, exit_index=exit_index)
        cloud = transformer.cloud_forward(params, cfg, edge["hidden"][final], exit_index=exit_index)
    torch.testing.assert_close(edge["exit_logits"][:, 0], exit_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(cloud["logits"][:, 0], final_ref, rtol=2e-4, atol=2e-4)


def test_qwen3_rows_are_independent(root):
    """A row's logits do not depend on the rows beside it in a block."""
    cell, model, reference = _cell(root, "qwen3-8b.exit0-s512-offload-half")
    spec = model.spec(cell.config, smoke=True)
    w = {k: v.float() for k, v in model.make_weights(
        seeds.generator(SEED, "weights", device="cpu"), spec, "cpu").items()}
    tokens = model.draw(None, seeds.generator(SEED, "window", device="cpu"), 4, {"seq_len": 9},
                        spec)
    every = torch.ones(4, dtype=torch.bool)
    e_all, f_all = reference.forward(w, spec, tokens, every)
    e_one, f_one = reference.forward(w, spec, model.rows(tokens, slice(2, 3)), every[:1])
    torch.testing.assert_close(e_all[2:3], e_one, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(f_all[2:3], f_one, rtol=1e-5, atol=1e-5)
