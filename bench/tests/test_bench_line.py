"""The result line's form, the metric readers on a synthetic record, and the
trace reduction on synthetic profiler events."""
import json

import pytest
from torch.autograd import DeviceType

from benchkit import peaks, runner, trace
from benchkit.manifest import Manifest

CELL = "b_alexnet.br1-offload-half"
K1_KERNELS = ("gate_group_kernel", "gate_warp_kernel", "gate_block_kernel")


class Event:
    """The part of a Kineto event the reduction reads."""

    def __init__(self, name, start, end, device):
        self._n, self._s, self._e = name, start, end
        self._d = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d


EVENTS = [
    Event("bench.window", 0, 1000, False),
    Event("bench.draw", 0, 100, False),
    Event("bench.infer", 100, 1000, False),
    Event("bench.edge", 100, 500, False),
    Event("bench.cloud", 600, 1000, False),
    Event("bench.infer", 100, 1000, True),  # the annotation's device copy: no work
    Event("Context Sync", 400, 500, True),
    Event("void gate_block_kernel<float>(float const*)", 150, 300, True),
    Event("conv", 250, 450, True),
    Event("conv", 700, 900, True),
]


def test_trace_reduction():
    r = trace.reduce(EVENTS)
    assert r["window_s"] == pytest.approx(1e-6)
    assert r["busy_s"] == pytest.approx(500e-9)  # [150, 450) and [700, 900)
    assert r["ops"]["conv"] == (2, pytest.approx(400e-9))
    idle = {k: v for k, v in r["idle"].items()}
    # [0, 150) under draw then edge, [450, 700) edge then infer, [900, 1000) cloud
    assert idle["bench.draw"] == (1, pytest.approx(150e-9))
    assert idle["bench.infer"] == (1, pytest.approx(250e-9))
    assert idle["bench.cloud"] == (1, pytest.approx(100e-9))
    assert trace.kernel_time(r, K1_KERNELS) == (1, pytest.approx(150e-9))
    b = trace.breakdown(r)
    assert [name for name, _ in b["device_ops"]] == ["conv x2", "void gate_block_kernel<float>"
                                                      "(float const*) x1"]


def _record(with_trace):
    return {
        "setup_s": 12.5, "window_s": 2.0, "batches": 4, "samples": 400,
        "latencies_s": [0.1, 0.2, 0.3, 0.4],
        "stats": {"requests": 400, "on_device": 300, "offloaded": 100, "payload_bytes": 0,
                  "edge_calls": 4, "cloud_calls": 2, "edge_time_s": 0.4, "cloud_time_s": 0.2},
        "flops": 67e12, "peak_flops": peaks.FLOPS["float32"],
        "trace": trace.reduce(EVENTS) if with_trace else None,
        "rows": 10, "classes": 8, "logit_bytes": 2,
        "payload": [{"shape": [16, 16, 64], "dtype": "float32", "bytes_per_row": 65536}],
    }


def test_metric_readers(root):
    cell = Manifest(root).cell(CELL)
    got = {m["name"]: cell.metric_reader(m["name"])(_record(True))
           for m in cell.metrics_e2e + cell.metrics_layer}
    want = {"samples_per_s": 200.0, "latency_p95_ms": 385.0, "setup_s": 12.5,
            "engine_host_ms": 100.0, "offload_share": 25.0, "edge_ms": 100.0, "cloud_ms": 100.0,
            "mfu": 50.0, "k1_roofline": 100 * (10 * 8 * 2 + 10 * 12) / 3.35e12 / 150e-9, "idle_share": 50.0}
    assert got == pytest.approx(want)
    untraced = {m["name"]: cell.metric_reader(m["name"])(_record(False))
                for m in cell.metrics_layer}
    assert untraced["k1_roofline"] is None and untraced["idle_share"] is None


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(root, traced):
    cell = Manifest(root).cell(CELL)
    result, lines = runner.run(root, CELL, 2**31 + 202, 0.2, traced, device="cpu", smoke=True)
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert isinstance(result["correct"], bool) and result["attempted"] > 0
    want = cell.metrics_layer if traced else cell.metrics_e2e
    units = {m["name"]: m["unit"] for m in want}
    assert set(result["metrics"]) <= set(units)
    for name, m in result["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in result["breakdown"].values())
    else:
        assert set(result["metrics"]) == set(units)
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}
        assert any(line.startswith(f"check: {name} ") for line in lines)
    json.dumps(result)
