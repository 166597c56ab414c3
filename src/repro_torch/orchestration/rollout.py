"""QoS-gated canary rollout of versioned `PlanBank`s.

The rollout manager is a four-state machine driven once per simulator
window:

    IDLE --(t >= start_at_s)--> CANARY: the candidate bank's gate table
        (built by `table_factory`, so it serves the exact same data as
        the incumbent) is installed on the k canary cells only;
    CANARY --(any canary cell QoS-tripped)--> ROLLED_BACK: every
        override is removed; the fleet is back on the incumbent;
    CANARY --(promote_after consecutive windows with no canary cell
        tripped)--> PROMOTED: the candidate table is installed
        fleet-wide.

Versions are monotonic: the candidate's ``bank_version`` must exceed the
incumbent's (`PlanBank.bumped` mints the next generation). Everything is
deterministic -- the same candidate, SLO, and workload replay the same
promotion or rollback at the same window.

Port of `repro.orchestration.rollout`: host Python over the port's
`PlanBank`; the candidate's gate table comes from `table_factory`, which
decides its gate backend and device.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.bank import PlanBank

IDLE = "idle"
CANARY = "canary"
PROMOTED = "promoted"
ROLLED_BACK = "rolled_back"


class RolloutManager:
    def __init__(
        self,
        candidate: PlanBank,
        table_factory: Callable[[PlanBank], object],
        canary_cells: Sequence[int],
        promote_after: int = 8,
        start_at_s: float = 0.0,
        incumbent_version: int = 0,
    ):
        if candidate.bank_version <= incumbent_version:
            raise ValueError(
                f"candidate bank_version {candidate.bank_version} must exceed "
                f"the incumbent's {incumbent_version} (versions are monotonic)"
            )
        if not canary_cells:
            raise ValueError("need at least one canary cell")
        if promote_after < 1:
            raise ValueError("promote_after must be >= 1")
        self.candidate = candidate
        self.table_factory = table_factory
        self.canary_cells: Tuple[int, ...] = tuple(int(c) for c in canary_cells)
        self.promote_after = int(promote_after)
        self.start_at_s = float(start_at_s)
        self.incumbent_version = int(incumbent_version)
        self.reset()

    def reset(self) -> None:
        self.state = IDLE
        self._table = None
        self._clear_windows = 0
        self.started_at: Optional[float] = None
        self.promoted_at: Optional[float] = None
        self.rolled_back_at: Optional[float] = None
        self.tripped_canaries: List[int] = []

    # ---------------------------------------------------------------- step
    def step(self, sim, tel, monitor, now: float) -> None:
        """One window boundary. `monitor` must have been observed for this
        boundary already (the Orchestrator orders it so)."""
        if self.state == IDLE:
            if now >= self.start_at_s:
                self._table = self.table_factory(self.candidate)
                for c in self.canary_cells:
                    sim.set_cell_table(c, self._table)
                self.state = CANARY
                self.started_at = now
                tel.record_orchestration(
                    now, "rollout_canary",
                    bank_version=self.candidate.bank_version,
                    incumbent_version=self.incumbent_version,
                    cells=list(self.canary_cells),
                )
        elif self.state == CANARY:
            bad = [c for c in self.canary_cells if monitor.is_tripped(c)]
            if bad:
                for c in self.canary_cells:
                    sim.set_cell_table(c, None)
                self.state = ROLLED_BACK
                self.rolled_back_at = now
                self.tripped_canaries = bad
                tel.record_orchestration(
                    now, "rollout_rollback",
                    bank_version=self.candidate.bank_version,
                    restored_version=self.incumbent_version,
                    tripped=bad,
                )
            else:
                self._clear_windows += 1
                if self._clear_windows >= self.promote_after:
                    for c in range(sim.topology.n_cells):
                        sim.set_cell_table(c, self._table)
                    self.state = PROMOTED
                    self.promoted_at = now
                    tel.record_orchestration(
                        now, "rollout_promote",
                        bank_version=self.candidate.bank_version,
                    )
        # PROMOTED / ROLLED_BACK are terminal for one run
