"""The compiled fleet sharded over cells (`repro_torch.fleet.compiled`
over `sharding.fleet_mesh`), on four gloo ranks on the CPU.

The scenario of tests/test_fleet_compiled.py's multi-device test: the
8-cell `reference_fleet` at 150 requests a cell, two cells a rank, with
the reference's plans carried over as JSON. The oracle is the one that
test holds its sharded run to: the reference's host simulator,
`repro.fleet.scenarios.run_fleet(..., backend="numpy")`, on the same
scenario (the reference's compiled fleet itself needs
`jax.experimental.enable_x64`, which this JAX lacks).
The port's one-device compiled run and its host simulator on the same
table are held beside it as two more witnesses. Beside the static bank
(``mesh="auto"``, through `run_fleet`), churn shed routing and a
whole-fleet outage (the backhaul lanes) run over the mesh with full
observability, and a mesh of the first two ranks (the other two run
alone).

Tolerances, as tests/test_torch_fleet_compiled.py: per-request latencies
and the summaries' ``*_ms`` rtol 1e-9 / atol 1e-12; every other column,
summary number, orchestration event and counter equal; every rank's
result the same.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro.fleet.scenarios import reference_fleet as jreference_fleet
from repro.fleet.scenarios import run_fleet as jrun_fleet
from repro.obs import full_observability as jfull
from repro.orchestration import ChurnSchedule as JChurn
from repro.orchestration import Orchestrator as JOrchestrator
from repro.serving import scenarios as jscn
from repro_torch.core.bank import PlanBank
from repro_torch.core.gatepath import TorchGateBackend
from repro_torch.core.policy import OffloadPlan
from repro_torch.fleet import CompiledFleetSimulator, CompiledGateBackend
from repro_torch.fleet.scenarios import fleet_gate_table, reference_fleet, run_fleet
from repro_torch.offload import latency as L
from repro_torch.serving.scenarios import synthetic_distorted_cascade

SRC = Path(__file__).resolve().parents[1] / "src"
LAT_TOL = dict(rtol=1e-9, atol=1e-12)
N_CELLS, PER_CELL, RANKS = 8, 150, 4

# shared by the ranks and this module: the runs and what is compared of them
RUNS = textwrap.dedent('''
    from repro_torch.fleet.telemetry import _CellColumns
    from repro_torch.obs import full_observability
    from repro_torch.orchestration import ChurnSchedule, Orchestrator

    def digest(tel, obs=None):
        """What two runs must agree on, as plain data."""
        out = {"cols": [{f: tel._cells[c].column(f) for f in _CellColumns.FIELDS}
                        for c in range(tel.n_cells)],
               "fleet": tel.fleet_summary(), "cells": tel.per_cell_summary(),
               "events": list(tel.orchestration_events)}
        if obs is not None:
            out["counters"] = {c: obs.metrics.counter_total(c) for c in (
                "fleet_requests_total", "fleet_offloaded_total", "fleet_shed_total",
                "fleet_uplink_bytes_total")}
        return out

    def orchestrated(run, plan, scn, backend, churn=ChurnSchedule, orchestrator=Orchestrator,
                     full=full_observability):
        """Churn shed of cells 0 and 5, and a whole-fleet outage, each with
        full observability (the port's classes unless others are given)."""
        out = {}
        for name, cells in (("shed", [0, 5]), ("outage", list(range(scn.topology.n_cells)))):
            obs = full(trace_sample_every=3)
            orch = orchestrator(churn=churn.outage(cells, start_s=2.0, duration_s=2.0))
            out[name] = digest(run(plan, scn, backend=backend, orchestrator=orch, obs=obs), obs)
        return out
''')
exec(RUNS)  # noqa: S102 - the same definitions as the ranks'

WORKER = RUNS + textwrap.dedent('''
    import pickle, sys
    import torch.distributed as dist
    from repro_torch.core.bank import PlanBank
    from repro_torch.core.policy import OffloadPlan
    from repro_torch.fleet import CompiledFleetSimulator, CompiledGateBackend, FleetConfig
    from repro_torch.fleet.scenarios import fleet_gate_table, reference_fleet, run_fleet
    from repro_torch.launch.mesh import join_ranks
    from repro_torch.offload import latency as L
    from repro_torch.sharding import fleet_mesh

    join_ranks("cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    with open(sys.argv[1], "rb") as f:
        job = pickle.load(f)
    bank, glob = PlanBank.from_json(job["bank"]), OffloadPlan.from_json(job["glob"])
    comp = CompiledGateBackend(device="cpu")
    scn = reference_fleet(n_cells=job["n_cells"], requests_per_cell=job["per_cell"], seed=0,
                          val=job["val"], test=job["test"])
    out = {"world": world}
    # mesh="auto" through run_fleet: the ranks divide the cells, so it shards
    table = fleet_gate_table(bank, scn, backend=comp)
    auto = CompiledFleetSimulator(table, scn.topology, L.paper_2020(),
                                  config=FleetConfig(window_s=0.5))
    out["auto_mesh"] = (auto.mesh.axis_names, auto.mesh.shape, auto._shard()[:2])
    out["bank"] = digest(run_fleet(bank, scn, backend=comp))
    out["orchestrated"] = orchestrated(run_fleet, glob.with_compression(2), scn, comp)
    # a mesh of the first two ranks; the others run alone
    half = fleet_mesh(2)
    sim = CompiledFleetSimulator(table, scn.topology, L.paper_2020(),
                                 config=FleetConfig(window_s=0.5), mesh=half)
    out["half_shard"] = None if sim._shard() is None else sim._shard()[:2]
    out["half"] = digest(sim.run())
    errors = []
    try:
        fleet_mesh(world + 1)
    except ValueError as e:
        errors.append(str(e))
    six = reference_fleet(n_cells=6, requests_per_cell=20, seed=0, val=job["val"],
                          test=job["test"])
    try:
        CompiledFleetSimulator(fleet_gate_table(bank, six, backend=comp), six.topology,
                               L.paper_2020(), mesh=fleet_mesh())
    except ValueError as e:
        errors.append(str(e))
    out["errors"] = errors
    # "auto" over cells the ranks do not divide: every rank runs alone
    out["six_auto"] = CompiledFleetSimulator(fleet_gate_table(bank, six, backend=comp),
                                             six.topology, L.paper_2020()).mesh
    with open(f"{sys.argv[2]}.{rank}", "wb") as f:
        pickle.dump(out, f)
''')


def same(a, b, what=""):
    """Two digests agree: latencies to LAT_TOL, everything else equal."""
    assert len(a["cols"]) == len(b["cols"]), what
    for c, (x, y) in enumerate(zip(a["cols"], b["cols"])):
        for f in x:
            if f == "latency_s":
                np.testing.assert_allclose(x[f], y[f], **LAT_TOL, err_msg=f"{what} cell {c}")
            else:
                np.testing.assert_array_equal(x[f], y[f], err_msg=f"{what} cell {c} {f}")
    for s, t in [(a["fleet"], b["fleet"])] + list(zip(a["cells"], b["cells"])):
        assert s.keys() == t.keys(), what
        for k in s:
            if k.endswith("_ms"):
                np.testing.assert_allclose(s[k], t[k], **LAT_TOL, err_msg=f"{what} {k}")
            else:
                assert s[k] == t[k] or (s[k] != s[k] and t[k] != t[k]), (what, k, s[k], t[k])
    assert a["events"] == b["events"], what
    assert a.get("counters") == b.get("counters"), what


@pytest.fixture(scope="module")
def fleet_runs(tmp_path_factory):
    """Every rank's results, the reference's host runs and the port's
    one-device compiled and host runs, and (val, test, the global plan)."""
    d = tmp_path_factory.mktemp("ranks_fleet")
    val, test = synthetic_distorted_cascade(directions={"gaussian_blur": "under"})
    jval, jtest = jscn.synthetic_distorted_cascade(directions={"gaussian_blur": "under"})
    np.testing.assert_array_equal(test["labels"], jtest["labels"])
    _, jglob, jbank = jscn.fit_drift_plans(jval)
    glob, bank = OffloadPlan.from_json(jglob.to_json()), PlanBank.from_json(jbank.to_json())
    with open(d / "job.pkl", "wb") as f:
        pickle.dump(dict(bank=bank.to_json(), glob=glob.to_json(), val=val, test=test,
                         n_cells=N_CELLS, per_cell=PER_CELL), f)
    (d / "worker.py").write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(RANKS), str(d / "worker.py"), str(d / "job.pkl"), str(d / "out")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # the one-device runs while the ranks run
    kw = dict(n_cells=N_CELLS, requests_per_cell=PER_CELL, seed=0, val=val, test=test)
    scn, jscn_ = reference_fleet(**kw), jreference_fleet(**kw)
    comp, host = CompiledGateBackend(device="cpu"), TorchGateBackend(device="cpu")
    one = {"bank": {"reference": digest(jrun_fleet(jbank, jscn_, backend="numpy")),
                    "compiled": digest(run_fleet(bank, scn, backend=comp)),
                    "host": digest(run_fleet(bank, scn, backend=host))},
           "orchestrated": {
               "reference": orchestrated(jrun_fleet, jglob.with_compression(2), jscn_, "numpy",
                                         churn=JChurn, orchestrator=JOrchestrator, full=jfull),
               "compiled": orchestrated(run_fleet, glob.with_compression(2), scn, comp),
               "host": orchestrated(run_fleet, glob.with_compression(2), scn, host)}}
    try:
        _, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        _, err = proc.communicate()
        raise AssertionError(f"the ranks did not finish in 300 s:\n{err[-4000:]}")
    assert proc.returncode == 0, err[-4000:]
    outs = []
    for r in range(RANKS):
        with open(d / f"out.{r}", "rb") as f:
            outs.append(pickle.load(f))
    return outs, one, (val, test, glob)


def test_sharded_fleet_equals_one_device_and_host_runs(fleet_runs):
    """mesh="auto" over four ranks, two cells each, through run_fleet:
    every rank's telemetry equals the reference's host simulator's, the
    port's one-device compiled run's and its host simulator's on the same
    table."""
    outs, one, _ = fleet_runs
    for r, out in enumerate(outs):
        assert out["world"] == RANKS
        assert out["auto_mesh"] == (("cells",), (RANKS,), (r, RANKS))
        same(out["bank"], one["bank"]["reference"], f"rank {r} against the reference")
        same(out["bank"], one["bank"]["compiled"], f"rank {r} against one device")
        same(out["bank"], one["bank"]["host"], f"rank {r} against the host simulator")
    assert one["bank"]["compiled"]["fleet"]["requests"] == N_CELLS * PER_CELL


@pytest.mark.parametrize("name", ["shed", "outage"])
def test_sharded_fleet_with_churn_and_observability(fleet_runs, name):
    """Shed batches served by another cell's lane, and the backhaul lanes
    of a whole-fleet outage, over the mesh: the same columns, events and
    counters on every rank as in the reference's host run, on one device
    and on the port's host."""
    outs, one, _ = fleet_runs
    kinds = {k for _, k, _ in one["orchestrated"]["reference"][name]["events"]}
    assert kinds, name
    for r, out in enumerate(outs):
        got = out["orchestrated"][name]
        same(got, one["orchestrated"]["reference"][name], f"{name}: rank {r} against the "
             "reference")
        same(got, one["orchestrated"]["compiled"][name], f"{name}: rank {r} against one device")
        same(got, one["orchestrated"]["host"][name], f"{name}: rank {r} against the host")


def test_mesh_of_some_ranks_and_the_rejections(fleet_runs):
    """fleet_mesh(2) shards over ranks 0 and 1 while ranks 2 and 3 run
    alone, all to the same result; more ranks than there are raise "asked
    for", a mesh that does not divide the cells "shard evenly", and
    "auto" over such cells runs alone."""
    outs, one, _ = fleet_runs
    assert [o["half_shard"] for o in outs] == [(0, 2), (1, 2), None, None]
    for r, out in enumerate(outs):
        same(out["half"], one["bank"]["reference"], f"half mesh: rank {r}")
        same(out["half"], one["bank"]["compiled"], f"half mesh: rank {r} against one device")
        asked, evenly = out["errors"]
        assert asked == f"asked for {RANKS + 1} mesh devices, have {RANKS}"
        assert "6 cells do not shard evenly over a 4-device mesh" in evenly
        assert out["six_auto"] is None


def test_one_device_mesh_without_a_group(fleet_runs):
    """Without a process group fleet_mesh() is one device and the run is
    the one-device run."""
    from repro_torch.sharding import fleet_mesh

    val, test, glob = fleet_runs[2]
    scn = reference_fleet(n_cells=2, requests_per_cell=40, val=val, test=test)
    table = fleet_gate_table(glob, scn, backend=CompiledGateBackend(device="cpu"))
    sim = CompiledFleetSimulator(table, scn.topology, L.paper_2020(), mesh=fleet_mesh())
    assert sim.mesh.shape == (1,) and sim._shard() is None
    same(digest(sim.run()), digest(run_fleet(glob, scn, backend=TorchGateBackend(device="cpu"))))
