"""The served path's spans (`repro_torch.obs.span`) on the CPU.

With no profiler on, no span is entered (a profiler range raises here)
and `OffloadEngine.infer` answers bit for bit as its body did before it
carried spans (`_unspanned_infer`). Under `torch.profiler.profile` the
``engine.*`` children tile each ``engine.infer`` in their order,
``engine.codec`` only at a non-zero codec level, ``lm.mixer`` and
``lm.ffn`` come once per block of each partition and ``lm.head`` once per
partition, and the serving runtime's `EngineCore` carries ``engine.edge``
and ``engine.cloud``.
"""
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch.configs import get_smoke
from repro_torch.core.calibration import TemperatureScaling
from repro_torch.core.exits import gate_statistics
from repro_torch.core.policy import OffloadPlan
from repro_torch.data.synthetic import cifar_like
from repro_torch.kernels import compress
from repro_torch.models import convnet, transformer
from repro_torch.obs import span
from repro_torch.offload.engine import convnet_engine, lm_engine
from repro_torch.serving import EngineCore

ENGINE = ["engine.edge", "engine.gate", "engine.select", "engine.codec", "engine.cloud",
          "engine.merge", "engine.fetch"]
#: the LM: exits after layers 0 and 2 of 4, served at exit 0
LM_LAYERS, LM_EXIT_AFTER = 4, 0


def _plan(logits, level, n_exits):
    """p_tar at the median calibrated confidence (an even count: no row sits
    on it), so both routes occur."""
    conf = gate_statistics(logits, 1.3)[0].numpy()
    return OffloadPlan(p_tar=float(np.median(conf)),
                       calibrators=[TemperatureScaling.from_temperature(1.3)] * n_exits,
                       compression_level=level)


def _convnet(level):
    params = convnet.init_params(torch.Generator().manual_seed(0), device="cpu")
    images = cifar_like(n_train=8, n_val=8, n_test=32, seed=3).test_x
    logits, _ = convnet.edge_forward(params, torch.as_tensor(images), branch=1)
    plan = _plan(logits, level, 2)
    return convnet_engine(params, plan, branch=1, device="cpu"), {"images": images}


def _lm(level):
    cfg = get_smoke("qwen3-8b").replace(dtype="float32", vocab_size=256, num_layers=LM_LAYERS,
                                        exit_layers=(LM_EXIT_AFTER, 2))
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (16, 8), generator=torch.Generator().manual_seed(1))
    logits = transformer.edge_forward(params, cfg, {"tokens": tokens})["exit_logits"][:, 0]
    plan = _plan(logits, level, 2)
    return lm_engine(params, cfg, plan, exit_index=0, device="cpu"), {"tokens": tokens}


ENGINES = {"convnet": _convnet, "lm": _lm}
CASES = [("convnet", 0), ("convnet", 2), ("lm", 0), ("lm", 1)]


def _unspanned_infer(eng, batch):
    """`OffloadEngine.infer`'s computation as it stood before the spans."""
    edge_out = eng.edge_fn(batch)
    gate = eng.plan.gate(edge_out["exit_logits"], branch=eng.branch, use_kernel=eng.use_kernel)
    mask = gate.exit_mask
    pred, conf = gate.prediction.clone(), gate.confidence.clone()
    refused = torch.nonzero(~mask).reshape(-1)
    if refused.numel():
        payload = pytree.tree_map(lambda x: x.index_select(0, refused), edge_out["payload"])
        level = eng.plan.compression_level
        if level != 0:
            leaves, spec = pytree.tree_flatten(payload)
            payload = pytree.tree_unflatten(
                [compress.decode(compress.encode(x, level)) for x in leaves], spec)
        logits = eng.cloud_fn(payload)["logits"].to(torch.float32)
        z = logits - torch.amax(logits, dim=-1, keepdim=True)
        p = torch.exp(z) / torch.sum(torch.exp(z), dim=-1, keepdim=True)
        pred[refused] = torch.argmax(logits, dim=-1).to(pred.dtype)
        conf[refused] = torch.amax(p, dim=-1)
    return {"prediction": pred.numpy(), "confidence": conf.numpy(), "on_device": mask.numpy()}


def _spans(prof):
    """(start, end, name) of the program's spans, by start."""
    return sorted((e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(("engine.", "lm.")))


def _within(spans, outer, prefix):
    s0, t0, _ = outer
    return [sp for sp in spans if s0 <= sp[0] and sp[1] <= t0 and sp != outer
            and sp[2].startswith(prefix)]


def _assert_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def _raise(*args, **kwargs):
    raise AssertionError("a span was entered with no profiler on")


def _no_ranges(monkeypatch):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)


def test_span_is_one_shared_no_op_without_a_profiler(monkeypatch):
    _no_ranges(monkeypatch)
    assert span("engine.infer") is span("lm.ffn")
    with span("engine.infer"):
        pass


def test_span_is_no_user_annotation_under_a_profiler():
    """A function-scope range: a user annotation would get a device-side
    copy, which a reader of the card's work would count as busy."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("engine.gate"):
            torch.ones(2).add_(1)
    got = [e for e in prof.profiler.kineto_results.events() if e.name() == "engine.gate"]
    assert len(got) == 1 and not got[0].is_user_annotation()


@pytest.mark.parametrize("model,level", CASES)
def test_no_span_entered_and_answers_unchanged_without_a_profiler(monkeypatch, model, level):
    eng, batch = ENGINES[model](level)
    want = _unspanned_infer(eng, batch)
    assert 0 < (~want["on_device"]).sum() < len(want["on_device"])
    _no_ranges(monkeypatch)
    _assert_equal(eng.infer(batch), want)


@pytest.mark.parametrize("model,level", CASES)
def test_engine_spans_tile_infer_in_order(model, level):
    eng, batch = ENGINES[model](level)
    want = _unspanned_infer(eng, batch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = [eng.infer(batch) for _ in range(2)]
    for out in got:
        _assert_equal(out, want)
    spans = _spans(prof)
    infers = [sp for sp in spans if sp[2] == "engine.infer"]
    assert len(infers) == 2
    order = [name for name in ENGINE if level != 0 or name != "engine.codec"]
    for outer in infers:
        children = _within(spans, outer, "engine.")
        assert [name for _, _, name in children] == order
        ends = [outer[0]] + [t for _, t, _ in children]
        assert all(s >= end for (s, _, _), end in zip(children, ends))
        assert children[-1][1] <= outer[1]
        if model == "lm":
            edge, cloud = children[0], children[order.index("engine.cloud")]
            for part, blocks in ((edge, LM_EXIT_AFTER + 1), (cloud, LM_LAYERS - LM_EXIT_AFTER - 1)):
                names = [name for _, _, name in _within(spans, part, "lm.")]
                assert names.count("lm.mixer") == names.count("lm.ffn") == blocks
                assert names.count("lm.head") == 1 and names[-1] == "lm.head"
                assert names[:-1] == ["lm.mixer", "lm.ffn"] * blocks
        else:
            assert not [sp for sp in spans if sp[2].startswith("lm.")]


def test_engine_core_carries_the_partition_spans():
    eng, batch = _convnet(0)
    core = EngineCore({1: eng}, batch, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        routes = [core.gate(k, 1, eng.plan.p_tar)[0] for k in range(8)]
        refused = routes.index(False)
        core.cloud_predict(refused, 1)
    names = [name for _, _, name in _spans(prof)]
    assert names.count("engine.edge") == 8 and names.count("engine.cloud") == 1
    assert "engine.infer" not in names
