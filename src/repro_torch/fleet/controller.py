"""Fleet-level offload controller: fleet policy over the shared core.

The candidate-table construction, mix-weighted context-aware re-scoring,
feasibility rules, and the distress-gated p_tar concession all live in
`repro_torch.core.control` and are shared with the event runtime's
`OnlineController`. What remains here is genuinely fleet-scale policy:
every cell sees a different link and arrival rate, and all cells share
one cloud tier -- a re-score that is locally optimal per cell can
collectively saturate the cloud. `FleetController` therefore runs the
shared re-score per cell (same calibrators, same candidate table,
per-cell measured bandwidth/arrivals/traffic mix from the windowed fleet
telemetry) and then applies a shared-cloud pass: while the aggregate
cloud utilization

    rho = sum_c arrival_c * offload_prob_c * cloud_time(branch_c) / K

exceeds ``cloud_rho_max``, the heaviest-contributing cell is moved to its
least-cloud-hungry accuracy-feasible candidate. Cells the simulator never
saw transfer fall back to the profile's nominal uplink, mirroring the
single-cell controller's cold-start rule.

Port of `repro.fleet.controller`. The controller core's validation blocks
are gate blocks of the selected `GateBackend` (`backend`, the port's
``"torch"`` by default: one K1 launch per (context, branch) on the card at
construction, and one K3 + K4 round trip of the final logits per codec
level when `compression_levels` is set); every tick is host numpy over the
cached statistics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.control import (
    ControlConfig,
    ControllerCore,
    choose_with_concession,
    row_feasible,
)
from repro_torch.offload import latency as L


@dataclass
class FleetControllerConfig(ControlConfig):
    """The shared control knobs (`repro_torch.core.control.ControlConfig`) plus
    the shared-cloud utilization cap. The concession threshold
    ``distress_utilization`` is inherited: a cell holds the PLAN's p_tar
    (moving only its branch) while any candidate at full p_tar keeps its
    uplink stable, and otherwise makes the WEAKEST concession -- the
    highest p_tar whose offload traffic fits the measured link -- rather
    than the latency-greedy one."""

    cloud_rho_max: Optional[float] = 0.9  # shared-cloud utilization cap


class FleetController:
    """Per-cell (branch, p_tar) decisions under a shared cloud budget.

    Construction mirrors `OnlineController` (held-out validation logits
    per physical branch, optional labels/final logits for the accuracy
    floor); a `PlanBank` contributes its default plan, composing with the
    per-sample expert selection inside the gate table exactly as in the
    event runtime. ``cloud_servers`` is the shared tier's parallelism --
    the denominator of the utilization cap.

    `exit_logits` is either ``{branch: (N, C)}`` -- the context-blind
    form -- or ``{context: {branch: (N, C)}}`` with matching
    `final_logits` per context, which makes the re-score CONTEXT-AWARE:
    each tick, every cell's candidate table is computed with the
    validation samples weighted by that cell's estimated traffic mix over
    the trailing window (`FleetTelemetry.context_mix_estimate`), so
    offload probabilities and accuracies price the drifting inputs the
    cell is actually serving. A context-blind controller under drift can
    badly underestimate a candidate's offload traffic (clean inputs gate
    confidently; distorted ones do not) and leave a distressed cell
    saturated -- the rescoring the event runtime's `OnlineController`
    now shares.

    `backend` selects the gate execution path of the controller core
    (`repro_torch.core.gatepath`): None is ``"torch"``, which runs on the
    card and raises without one; ``"numpy"`` or
    ``TorchGateBackend(device="cpu")`` stay on the host.
    """

    def __init__(
        self,
        plan,
        profile: L.LatencyProfile,
        exit_logits: Dict,
        n_cells: int,
        final_logits=None,
        labels: Optional[np.ndarray] = None,
        cloud_servers: int = 1,
        config: Optional[FleetControllerConfig] = None,
        payload_nbytes=None,
        backend=None,
    ):
        cfg = config or FleetControllerConfig()
        self.core = ControllerCore(
            plan, profile, exit_logits,
            final_logits=final_logits, labels=labels,
            payload_nbytes=payload_nbytes,
            backend=backend,
            compression_levels=cfg.compression_levels,
        )
        self.plan = self.core.plan
        self.profile = profile
        self.n_cells = n_cells
        self.cloud_servers = cloud_servers
        self.config = cfg
        if (
            self.config.p_tar_grid is not None
            and self.plan.p_tar not in self.config.p_tar_grid
        ):
            # the contract-holding stage of choose_with_concession matches
            # rows at the PLAN's p_tar; a grid omitting it would silently
            # treat every cell as distressed, so always keep it available
            self.config = FleetControllerConfig(
                **{**self.config.__dict__,
                   "p_tar_grid": tuple(self.config.p_tar_grid)
                   + (self.plan.p_tar,)}
            )
        self.history: List[Tuple[float, List[Tuple[int, float, int]]]] = []
        #: optional repro_torch.obs.AuditLog (injected by `run_fleet(obs=...)` /
        #: FleetSimulator); records per-cell rescore evidence + decisions
        self.audit = None
        self._last_decisions: Optional[List[Tuple[int, float, int]]] = None

    @property
    def branches(self) -> List[int]:
        return self.core.branches

    @property
    def ctx_keys(self) -> List[Optional[str]]:
        return self.core.ctx_keys

    @property
    def interval_s(self) -> float:
        return self.config.interval_s

    # ------------------------------------------------------------- update
    def _cell_mix(self, telemetry, c: int, t: float) -> Optional[Dict[str, float]]:
        """This cell's trailing-window traffic mix as {context: share};
        None when context-blind or nothing recognizable was observed."""
        if not self.core.context_aware:
            return None
        raw = telemetry.context_mix_estimate(c, self.config.window_s, now=t)
        if raw is None:
            return None
        return dict(zip(telemetry.context_keys, np.asarray(raw, np.float64)))

    def update(
        self, t: float, telemetry, active=None, distressed=None
    ) -> List[Tuple[int, float, int]]:
        """-> per-cell (physical branch, p_tar, compression_level)
        decisions.

        `active` (orchestrated runs): a (C,) bool mask; a DOWN cell is not
        re-scored -- its telemetry window mixes its own last traffic with
        shed service on other cells' links -- and instead parks at the
        plan's deployment, the state it must come back up in. It also
        contributes zero load to the shared-cloud pass (its arrivals are
        priced on the host cell that serves them).

        `distressed` (orchestrated runs with a QoS monitor): a (C,) bool
        mask of cells whose declared SLO is TRIPPED. A distressed cell
        stops holding the contract p_tar and takes the fastest stable
        feasible candidate (`choose_with_concession(force_concession=
        True)`) until the monitor clears it -- the trip verdict IS the
        distress signal, not a second utilization heuristic."""
        cfg = self.config
        chosen_rows, tables, rates, inputs = [], [], [], []
        for c in range(self.n_cells):
            if active is not None and not active[c]:
                chosen_rows.append(None)
                tables.append(None)
                rates.append(0.0)
                inputs.append(None)
                continue
            bw = telemetry.bandwidth_estimate(c, cfg.window_s, now=t)
            if bw is None:
                bw = self.profile.uplink_bps  # nothing measured: trust nominal
            rate_hz = (
                telemetry.arrival_rate_estimate(c, cfg.window_s, now=t)
                if cfg.utilization_aware
                else None
            )
            _, table = self.core.rescore(
                self.plan,
                uplink_bps=bw,
                arrival_rate_hz=rate_hz,
                p_tar_grid=cfg.p_tar_grid,
                branches=cfg.branches,
                min_accuracy=cfg.min_accuracy,
                max_reliability_gap=cfg.max_reliability_gap,
                sample_weight=self.core.sample_weight_for_mix(
                    self._cell_mix(telemetry, c, t)
                ),
            )
            force = bool(distressed is not None and distressed[c])
            chosen_rows.append(
                choose_with_concession(
                    table, self.plan.p_tar, cfg.distress_utilization,
                    min_accuracy=cfg.min_accuracy,
                    max_reliability_gap=cfg.max_reliability_gap,
                    force_concession=force,
                )
            )
            tables.append(table)
            rates.append(rate_hz or 0.0)
            inputs.append({"bandwidth_bps": float(bw),
                           "arrival_rate_hz": None if rate_hz is None
                           else float(rate_hz),
                           "distressed": force})

        if cfg.cloud_rho_max is not None:
            chosen_rows = self._shared_cloud_pass(chosen_rows, tables, rates)

        hold = (
            self.plan.exit_index + 1,
            float(self.plan.p_tar),
            int(getattr(self.plan, "compression_level", 0)),
        )
        decisions = [
            hold if r is None
            else (r["exit_index"] + 1, float(r["p_tar"]),
                  int(r.get("compression_level", 0)))
            for r in chosen_rows
        ]
        if self.audit is not None:
            self._audit_decisions(t, decisions, chosen_rows, inputs)
        self._last_decisions = decisions
        self.history.append((t, decisions))
        return decisions

    def _audit_decisions(self, t, decisions, chosen_rows, inputs) -> None:
        """One audit record per cell whose decision changed or that is
        under QoS distress -- the evidence (measured inputs + chosen
        candidate row) a concession must be reconstructible from."""
        prev = self._last_decisions
        for c, (d, row, inp) in enumerate(zip(decisions, chosen_rows, inputs)):
            if inp is None:
                continue  # parked (inactive) cell: no rescore happened
            changed = prev is None or prev[c] != d
            if not (changed or inp["distressed"]):
                continue
            chosen = {"branch": int(d[0]), "p_tar": float(d[1]),
                      "compression_level": int(d[2])}
            if row is not None:
                chosen.update(
                    offload_prob=float(row["offload_prob"]),
                    expected_latency_s=float(row["expected_latency_s"]),
                    uplink_utilization=float(row["uplink_utilization"]),
                )
            self.audit.record(
                t, "fleet_controller", "controller_rescore", cell=c,
                changed=bool(changed), chosen=chosen, **inp)

    # ---------------------------------------------------- shared-cloud cap
    def _feasible(self, row) -> bool:
        return row_feasible(
            row, self.config.min_accuracy, self.config.max_reliability_gap
        )

    def _cloud_load(self, row, rate_hz: float) -> float:
        return (
            rate_hz * row["offload_prob"]
            * self.core.cloud_times_s[row["exit_index"]]
        )

    def _shared_cloud_pass(self, chosen, tables, rates):
        """Demote the heaviest cloud contributors until the shared tier's
        utilization fits under the cap (or no feasible demotion remains)."""
        cap = self.config.cloud_rho_max * self.cloud_servers
        loads = [
            0.0 if r is None else self._cloud_load(r, rate)
            for r, rate in zip(chosen, rates)
        ]
        frozen = {c for c, r in enumerate(chosen) if r is None}
        while sum(loads) > cap:
            order = sorted(
                (c for c in range(self.n_cells) if c not in frozen),
                key=lambda c: loads[c],
                reverse=True,
            )
            moved = False
            for c in order:
                alts = [
                    r for r in tables[c]
                    if self._feasible(r)
                    and self._cloud_load(r, rates[c]) < loads[c]
                ]
                if not alts:
                    frozen.add(c)
                    continue
                # least cloud-hungry feasible candidate; latency breaks ties
                best = min(
                    alts,
                    key=lambda r: (
                        self._cloud_load(r, rates[c]),
                        r["expected_latency_s"],
                    ),
                )
                chosen[c] = best
                loads[c] = self._cloud_load(best, rates[c])
                frozen.add(c)
                moved = True
                break
            if not moved:
                break
        return chosen
