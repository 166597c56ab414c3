"""``BENCHMARK.json`` and the files it names, found by name.

* a cell's traffic mix: ``bench/workloads/<cell>.json``;
* a configuration: the ``file`` its entry names (``config.json``), with
  ``model.py`` (seeded weights, inputs, the port's engine), ``reference.py``
  (the plain reference) and ``flops.py`` (the frozen FLOP count) beside it;
* a metric: ``bench/metrics/<metric>.py``, whose ``read(record)`` returns
  the number or None.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

BENCH = Path(__file__).resolve().parents[1]


def load_module(path: Path, name: str):
    """Import the Python file `path` as module `name` (once per process)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _module_name(kind: str, name: str, part: str) -> str:
    return "bench_" + kind + "_" + re.sub(r"[^A-Za-z0-9_]", "_", name) + "_" + part


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    name: str
    entry: Dict[str, Any]
    traffic: Dict[str, Any]  # the workload file
    config: Dict[str, Any]  # the configuration file
    config_dir: Path
    metrics_e2e: List[Dict[str, Any]]
    metrics_layer: List[Dict[str, Any]]
    root: Path

    def module(self, part: str):
        """The configuration's ``model``, ``reference`` or ``flops`` module."""
        return load_module(self.config_dir / f"{part}.py",
                           _module_name("config", self.entry["config"], part))

    def metric_reader(self, metric: str):
        path = self.root / "bench" / "metrics" / f"{metric}.py"
        return load_module(path, _module_name("metric", metric, "read")).read


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.exists():
            raise FileNotFoundError(f"no BENCHMARK.json at {self.root}")
        self.data = json.loads(path.read_text())

    def names(self, key: str) -> List[str]:
        return [e["name"] for e in self.data[key]]

    def _one(self, key: str, name: str) -> Dict[str, Any]:
        found = [e for e in self.data[key] if e["name"] == name]
        if len(found) != 1:
            raise KeyError(f"{key} has {len(found)} entries named {name!r}")
        return found[0]

    def cell(self, name: str) -> Cell:
        entry = self._one("workloads", name)
        cfg_entry = self._one("configs", entry["config"])
        cfg_path = self.root / cfg_entry["file"]
        traffic_path = self.root / "bench" / "workloads" / f"{name}.json"
        e2e = self.data["end_to_end"]
        reported = {m["name"] for m in e2e}
        layer = [m for m in self.data["per_layer"] if m["moves"] in reported]
        return Cell(name=name, entry=entry, traffic=json.loads(traffic_path.read_text()),
                    config=json.loads(cfg_path.read_text()), config_dir=cfg_path.parent,
                    metrics_e2e=e2e, metrics_layer=layer, root=self.root)
