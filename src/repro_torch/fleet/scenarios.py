"""Reference fleet scenarios shared by the acceptance tests and the
fleet benchmark, so the numbers CI asserts on and the numbers the tests
pin down come from the same construction.

`reference_fleet` scales the input-drift scenario out to C cells: the
same `synthetic_distorted_cascade` data and plans, but each cell gets its
own uplink (a heterogeneous mix of the paper's nominal fixed link, a
degraded fixed link, and the congested Markov Wi-Fi of the serving
bench) and its own Markov severity schedule (per-cell seeds -- weather is
not synchronized across sites). All cells feed one shared cloud tier.

`run_fleet` serves a plan/bank over that topology, optionally with the
`FleetController` re-scoring every cell each second under the shared
cloud cap -- the fleet-scale analogue of `run_distortion_drift`.

Port of `repro.fleet.scenarios`. The topology and its data are the
reference's numpy, draw for draw; `run_fleet` gates through one
`GateBackend` (``"torch"`` by default, on the card) shared by the gate
table and the fleet controller. ``"compiled"`` (the compiled fleet
simulator) is not ported yet and raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.gatepath import GateTable, get_gate_backend
from repro_torch.fleet.controller import FleetController, FleetControllerConfig
from repro_torch.fleet.simulator import FleetConfig, FleetSimulator
from repro_torch.fleet.telemetry import FleetTelemetry
from repro_torch.fleet.topology import CellConfig, FleetTopology, poisson_cell_workload
from repro_torch.offload import latency as L
from repro_torch.serving.drift import MarkovContextSchedule
from repro_torch.serving.network import FixedRateNetwork, MarkovNetwork
from repro_torch.serving.scenarios import drift_contexts, synthetic_distorted_cascade


def cell_network(i: int, nominal_bps: float = 18.8e6):
    """The reference heterogeneous link mix: most cells keep the paper's
    nominal Wi-Fi, one in eight runs a degraded fixed link, and one in
    eight the mostly-bad Markov chain of the serving bench. The minority
    of congested cells is the point: a fleet controller can concede
    latency-for-reliability trades *locally* (only where the link demands
    it) while the healthy majority keeps the full calibration win --
    which no fleet-wide static configuration can do."""
    kind = i % 16
    if kind == 3:
        return FixedRateNetwork(8e6)
    if kind == 11:
        return MarkovNetwork(
            good_bps=nominal_bps, bad_bps=1.5e6,
            p_good_to_bad=0.5, p_bad_to_good=0.2,
            dwell_s=1.0, seed=1000 + i, start_state=1,
        )
    return FixedRateNetwork(nominal_bps)


@dataclass
class FleetScenario:
    topology: FleetTopology
    val: dict
    test: dict
    contexts: List[str]


def reference_fleet(
    n_cells: int = 64,
    requests_per_cell: int = 1600,
    arrival_rate_hz: float = 20.0,
    deadline_s: float = 0.1,
    n_devices: int = 2,
    dwell_s: float = 3.0,
    cloud_servers: int = 4,
    seed: int = 0,
    val: Optional[dict] = None,
    test: Optional[dict] = None,
) -> FleetScenario:
    """The reference C-cell topology over the input-drift data, with one
    twist: blur drifts UNDERCONFIDENT (the direction the trained model of
    ``examples/offload_under_distortion.py`` exhibits) while noise and
    contrast stay overconfident. Under drift both directions coexist in
    one fleet, and a clean-fit uncalibrated plan loses on both axes: the
    overconfident regimes break its reliability, the underconfident one
    floods its uplinks."""
    if val is None or test is None:
        val, test = synthetic_distorted_cascade(
            seed=seed, directions={"gaussian_blur": "under"}
        )
    keys = [spec.key for spec in drift_contexts()]
    n_samples = len(test["labels"])
    cells = []
    for i in range(n_cells):
        cells.append(
            CellConfig(
                network=cell_network(i),
                workload=poisson_cell_workload(
                    arrival_rate_hz, requests_per_cell, n_samples,
                    n_devices=n_devices, seed=seed + 200 + i,
                ),
                n_devices=n_devices,
                schedule=MarkovContextSchedule(
                    keys, dwell_s=dwell_s, p_stay=0.5, seed=seed + 100 + i,
                    start_context="clean",
                ),
                deadline_s=deadline_s,
            )
        )
    return FleetScenario(
        topology=FleetTopology(cells, cloud_servers=cloud_servers),
        val=val, test=test, contexts=keys,
    )


def fleet_gate_table(plan_or_bank, scenario: FleetScenario, backend=None) -> GateTable:
    """The scenario's dense gate table for a plan/bank -- the shared
    construction `run_fleet` uses, exposed so orchestration scenarios can
    build CANDIDATE tables (same data, different bank) for rollout."""
    test = scenario.test
    return GateTable(
        test["exit_logits"], test["final"], plan_or_bank,
        labels=test["labels"], features_by_context=test.get("features"),
        backend=backend,
    )


def run_fleet(
    plan_or_bank,
    scenario: FleetScenario,
    with_controller: bool = False,
    window_s: float = 0.5,
    controller_config: Optional[FleetControllerConfig] = None,
    profile: Optional[L.LatencyProfile] = None,
    backend=None,
    orchestrator=None,
    fleet_config: Optional[FleetConfig] = None,
    obs=None,
) -> FleetTelemetry:
    """Serve the scenario's test split with a plan or expert bank.

    The gate table precomputes per-(context, expert, branch) blocks once;
    `with_controller` adds the fleet controller re-scoring every cell's
    (branch, p_tar) from its windowed telemetry under the shared cloud
    cap, fit on the CLEAN validation logits exactly as the single-cell
    controller in `run_distortion_drift`. `backend` selects the gate
    execution path of the table and the controller
    (`repro_torch.core.gatepath`): None is ``"torch"``, which runs on the
    card and raises without one; ``"numpy"`` or
    ``TorchGateBackend(device="cpu")`` stay on the host. `orchestrator`
    attaches an orchestration plane (`repro_torch.orchestration`) driving
    churn, QoS
    monitoring, and rollouts; `fleet_config` overrides the simulator
    config (e.g. cloud brownout intervals) and wins over `window_s`.
    `obs` attaches a `repro_torch.obs.Observability` bundle (sampled
    traces, decision audit log, metrics); None (the default) is
    zero-perturbation.

    backend="compiled" (the reference's compiled window pipeline) raises
    `NotImplementedError`: it is not ported yet, and the host simulator
    does not stand in for it.
    """
    backend = get_gate_backend(backend)
    profile = profile or L.paper_2020()
    val = scenario.val
    table = fleet_gate_table(plan_or_bank, scenario, backend=backend)
    controller = None
    if with_controller:
        controller = FleetController(
            plan_or_bank, profile,
            val["exit_logits"],  # per-context: the mix-weighted re-score
            n_cells=scenario.topology.n_cells,
            final_logits=val["final"], labels=val["labels"],
            cloud_servers=scenario.topology.cloud_servers,
            backend=backend,
            config=controller_config
            or FleetControllerConfig(
                interval_s=1.0, window_s=2.0,
                p_tar_grid=(0.3, 0.5, 0.7, 0.8), min_accuracy=0.8,
                cloud_rho_max=0.9,
            ),
        )
    sim = FleetSimulator(
        table, scenario.topology, profile,
        config=fleet_config or FleetConfig(window_s=window_s),
        controller=controller, orchestrator=orchestrator, obs=obs,
    )
    return sim.run()
