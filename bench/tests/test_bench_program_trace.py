"""The reading under the program's spans (`benchkit.program_trace`) on
synthetic Kineto events, its four metric readers, and `bench/spans.py`'s
traced run on the CPU at the smoke sizes."""
import pytest
from torch.autograd import DeviceType

from benchkit import program_trace
from benchkit.manifest import Manifest

CELL = "b_alexnet.br1-offload-half"
READERS = ("engine_idle_ms", "edge_idle_ms", "cloud_idle_ms", "launches_per_batch")


class Event:
    """The part of a Kineto event the reductions read."""

    def __init__(self, name, start, end, device=False, kind="kernel"):
        self._n, self._s, self._e, self._k = name, start, end, kind
        self._d = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def activity_type(self):
        return self._k


def _batch(t):
    """One batch's spans, kernels and launch calls from time t: the device
    busy over [t+130, t+180), [t+250, t+350) and [t+600, t+700) of the
    span engine.infer over [t+100, t+900)."""
    return [
        Event("engine.infer", t + 100, t + 900),
        Event("engine.edge", t + 100, t + 400),
        Event("lm.mixer", t + 120, t + 200),
        Event("lm.ffn", t + 200, t + 300),
        Event("engine.gate", t + 400, t + 450),
        Event("engine.cloud", t + 500, t + 800),
        Event("engine.fetch", t + 820, t + 880),
        # the annotations' device copies: no work
        Event("engine.infer", t + 100, t + 900, True, "gpu_user_annotation"),
        Event("lm.ffn", t + 200, t + 300, True, "gpu_user_annotation"),
        Event("attention", t + 130, t + 180, True),
        Event("mlp", t + 250, t + 350, True),
        Event("cloud", t + 600, t + 700, True),
        Event("cudaLaunchKernel", t + 100, t + 105),  # at edge's start: inside it
        Event("cudaLaunchKernel", t + 125, t + 127),
        Event("cuLaunchKernelEx", t + 210, t + 212),
        Event("cudaLaunchKernel", t + 510, t + 512),
        Event("cudaMemcpyAsync", t + 830, t + 832),
        Event("cudaStreamSynchronize", t + 840, t + 870),  # no launch
    ]


EVENTS = [Event("bench.window", 0, 2000), Event("bench.draw", 0, 100),
          Event("cudaLaunchKernel", 10, 12), Event("draw", 0, 50, True)] + _batch(0) + _batch(1000)


def _rows(reduced):
    return {path: (row["calls"], row["idle_s"] * 1e9, row["launches"])
            for path, row in reduced["paths"].items()}


def test_idle_split_exactly_at_nested_boundaries():
    r = program_trace.reduce(EVENTS)
    assert r["window_s"] == pytest.approx(2e-6)
    got = _rows(r)
    edge = "engine.infer/engine.edge"
    # the first batch's gaps: [50, 130), [180, 250) across lm.mixer's end,
    # [350, 600), [700, 1100); the second's the same 1000 later, to 2000
    want = {
        "": (0, 50 + 100 + 100 + 100, 1),
        "engine.infer": (2, 2 * (50 + 20 + 20), 0),
        edge: (2, 2 * (20 + 50), 2),
        edge + "/lm.mixer": (2, 2 * (10 + 20), 2),
        edge + "/lm.ffn": (2, 2 * 50, 2),
        "engine.infer/engine.gate": (2, 2 * 50, 0),
        "engine.infer/engine.cloud": (2, 2 * 200, 2),
        "engine.infer/engine.fetch": (2, 2 * 60, 2),
    }
    assert set(got) == set(want)
    for path, (calls, idle, launches) in want.items():
        assert got[path][0] == calls and got[path][2] == launches, path
        assert got[path][1] == pytest.approx(idle), path
    assert sum(row[1] for row in got.values()) == pytest.approx(2000 - 2 * 250 - 50)
    assert r["paths"]["engine.infer"]["seconds"] == pytest.approx(2 * 800e-9)


def test_gap_after_many_closed_children_falls_to_the_parent():
    """Twelve closed children, then a gap in the parent's own time: the
    parent's, not the window's (no look-back limit)."""
    events = [Event("bench.window", 0, 1000), Event("engine.cloud", 0, 1000),
              Event("busy", 0, 200, True), Event("busy", 300, 1000, True)]
    events += [Event(name, 10 * k + 5 * i, 10 * k + 5 * i + 5) for k in range(6)
               for i, name in enumerate(("lm.mixer", "lm.ffn"))]
    got = _rows(program_trace.reduce(events))
    assert got["engine.cloud"] == (1, pytest.approx(100), 0)
    assert got["engine.cloud/lm.mixer"] == (6, 0, 0) and got["engine.cloud/lm.ffn"] == (6, 0, 0)
    assert got[""] == (0, 0, 0)


def test_launches_and_idle_inside_a_span():
    r = program_trace.reduce(EVENTS)
    assert program_trace.under(r, "engine.infer", "launches") == (2, 10)
    assert program_trace.under(r, "engine.edge", "launches") == (2, 6)
    assert program_trace.under(r, "lm.ffn", "idle_s") == (2, pytest.approx(100e-9))
    calls, idle = program_trace.under(r, "engine.infer", "idle_s",
                                      without=("engine.edge", "engine.cloud"))
    assert calls == 2 and idle == pytest.approx(2 * (90 + 50 + 60) * 1e-9)
    assert program_trace.info(r).startswith("info: program spans")


def test_metric_readers(root):
    cell = Manifest(root).cell(CELL)
    record = {"program_trace": program_trace.reduce(EVENTS)}
    got = {name: cell.metric_reader(name)(record) for name in READERS}
    assert got == pytest.approx({"engine_idle_ms": 200e-6, "edge_idle_ms": 150e-6,
                                 "cloud_idle_ms": 200e-6, "launches_per_batch": 5.0})


def test_readers_none_untraced_or_without_program_spans(root):
    cell = Manifest(root).cell(CELL)
    bare = program_trace.reduce([Event("bench.window", 0, 100), Event("k", 10, 20, True)])
    assert set(bare["paths"]) == {""}
    no_cloud = program_trace.reduce([e for e in EVENTS if e.name() != "engine.cloud"])
    for record in ({"trace": None}, {"program_trace": None}, {"program_trace": bare}):
        assert all(cell.metric_reader(name)(record) is None for name in READERS)
    assert cell.metric_reader("cloud_idle_ms")({"program_trace": no_cloud}) is None
    assert cell.metric_reader("engine_idle_ms")({"program_trace": no_cloud}) is not None


@pytest.mark.parametrize("cell", [CELL, "qwen3-8b.exit0-s64-offload-half"])
def test_traced_run_reads_the_program_spans(root, cell):
    import spans

    result, lines = spans.traced_run(root, cell, 2**31 + 303, 0.2, device="cpu", smoke=True)
    paths = result["program_trace"]["paths"]
    batches = paths["engine.infer"]["calls"]
    assert batches >= 1 and paths["engine.infer/engine.edge"]["calls"] == batches
    lm = [p for p in paths if "lm." in p]
    assert bool(lm) == cell.startswith("qwen3")
    assert {"engine_idle_ms", "edge_idle_ms", "launches_per_batch"} <= set(
        result["program_metrics"])
    assert any(line.startswith("info: idle s under engine.infer") for line in lines)
