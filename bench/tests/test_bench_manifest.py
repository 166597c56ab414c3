"""BENCHMARK.json keeps its documented form, and the harness finds every
configuration, traffic mix and metric by name: a new traffic file in a
copy runs with no edit to any code."""
import json
import shutil
from pathlib import Path

import pytest

from benchkit import judge, runner
from benchkit.manifest import NAME, UNIT, Manifest

TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
MANIFEST = Path(__file__).resolve().parents[2] / "BENCHMARK.json"
CELLS = json.loads(MANIFEST.read_text())["workloads"]
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
}


@pytest.fixture(scope="module")
def manifest(root):
    return Manifest(root)


def test_keys_and_sizes(manifest):
    data = manifest.data
    assert set(data) == TOP
    assert 1 <= data["run_seconds"] <= 51 and isinstance(data["run_seconds"], int)
    for key, (required, optional) in KEYS.items():
        for entry in data[key]:
            assert required <= set(entry) <= required | optional, (key, entry)
    assert len((manifest.root / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(data["configs"]) <= 24 and 1 <= len(data["workloads"]) <= 24
    assert 1 <= len(data["end_to_end"]) <= 16 and 1 <= len(data["per_layer"]) <= 128
    assert data["command"][:2] == ["python3", "bench/run.py"] and data["paths"] == ["bench"]


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_text(manifest, key):
    entries = manifest.data[key]
    assert len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for field in ("unit",):
            if field in e:
                assert UNIT.match(e[field]), e[field]
        for field in ("why", "layer", "source"):
            if field in e:
                assert 1 <= len(e[field]) <= 200 and "\n" not in e[field] and "\t" not in e[field]
        if "better" in e:
            assert e["better"] in ("lower", "higher")
        if key == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and e["chips"] == 1
        if key == "configs":
            assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16


def test_metrics_sources_and_bounds(manifest):
    e2e = {m["name"]: m for m in manifest.data["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in manifest.data["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    cells = set(manifest.names("workloads"))
    for m in manifest.data["end_to_end"] + manifest.data["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c["name"])
def test_every_name_is_found(manifest, cell):
    found = manifest.cell(cell["name"])
    for part in ("model", "reference", "flops"):
        assert (found.config_dir / f"{part}.py").exists()
        found.module(part)
    names = [m["name"] for m in found.metrics_e2e + found.metrics_layer]
    assert "setup_s" in names and len(found.metrics_e2e) >= 2 and found.metrics_layer
    for name in names:
        assert callable(found.metric_reader(name))
    assert found.config["name"] == cell["config"]
    assert set(found.config["limits"]) >= set(judge.NAMES)


def test_new_traffic_file_runs_without_code_edits(root, tmp_path):
    shutil.copytree(root / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["workloads"].append({"name": "b_alexnet.br1-offload-third", "config": "b_alexnet",
                              "traffic": "br1-offload-third", "chips": 1,
                              "why": "a third of the images refused"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    work = json.loads((root / "bench/workloads/b_alexnet.br1-offload-half.json").read_text())
    work["quantile"] = 1 / 3
    (tmp_path / "bench/workloads/b_alexnet.br1-offload-third.json").write_text(json.dumps(work))
    result, _ = runner.run(tmp_path, "b_alexnet.br1-offload-third", 2**31 + 7, 0.2, False,
                           device="cpu", smoke=True)
    assert result["correct"]
    assert set(result["metrics"]) == {"samples_per_s", "latency_p95_ms", "setup_s"}
