"""Decision audit log: every control-plane action, with its evidence.

Port of `repro.obs.audit`.

Aggregate telemetry says *what* happened (p99 rose, the gap blew out);
the audit log says *why the system responded the way it did* -- which
QoS window tripped with what metric value against what cap, what
bandwidth/arrival evidence the controller rescored on and which
candidate row it chose, which bank version a rollout moved to and which
it restored on rollback, and where shed traffic was routed.

Records are flat dicts ``{"t_s", "actor", "action", "evidence": {...}}``
so the log greps cleanly as JSONL and reconstructs causal chains offline
(`repro_torch.obs.check.verify_rollback_chain` rebuilds the poisoned-canary
rollback -- trip evidence -> rollback transition -> restored version --
from the log alone).

Actors/actions currently emitted:

=================  =====================================================
actor              actions
=================  =====================================================
qos_monitor        qos_trip, qos_clear
rollout_manager    rollout_canary, rollout_promote, rollout_rollback
churn              churn_leave, churn_join
simulator          shed_route (neighbor or cloud backhaul)
fleet_controller   controller_rescore (per-cell decision + inputs)
online_controller  controller_rescore (single-cell serving runtime)
=================  =====================================================
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional


class AuditLog:
    """Append-only in-memory audit log with JSONL import/export."""

    def __init__(self):
        self.records: List[Dict] = []

    def record(self, t: float, actor: str, action: str, **evidence) -> Dict:
        rec = {"t_s": float(t), "actor": str(actor), "action": str(action),
               "evidence": evidence}
        self.records.append(rec)
        return rec

    def filter(self, action: Optional[str] = None,
               actor: Optional[str] = None,
               cell: Optional[int] = None) -> List[Dict]:
        out = self.records
        if action is not None:
            out = [r for r in out if r["action"] == action]
        if actor is not None:
            out = [r for r in out if r["actor"] == actor]
        if cell is not None:
            out = [r for r in out if r["evidence"].get("cell") == cell]
        return list(out)

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as fh:
            for r in self.records:
                fh.write(json.dumps(r))
                fh.write("\n")

    @staticmethod
    def read_jsonl(path: str) -> List[Dict]:
        out = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out

    def __len__(self) -> int:
        return len(self.records)
