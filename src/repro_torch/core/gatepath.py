"""The shared gate execution layer: one decision, two backends.

Port of `repro.core.gatepath`. Every serving surface makes the same
per-sample decision -- calibrate a branch's logits, take max-softmax
confidence and the argmax prediction, compare against the moving target
``p_tar`` -- and `GateBackend` is that evaluation as one swappable object:

* `NumpyGateBackend` (``"numpy"``) -- the host spec: eager
  `gate_statistics` per block on CPU tensors (K1's plain version), one
  call per distinct expert, float64 numpy outputs. It stays on the host
  whatever device the logits come from.
* `TorchGateBackend` (``"torch"``, the default) -- the card. It takes the
  place of the reference's jitted `JaxGateBackend`: a plan block is one K1
  launch at the plan's temperature; a bank block gathers each sample's
  expert temperature on the device, divides ``z / t`` in float32 (IEEE,
  as the reference's ``logits / temperature``) and makes one K1 launch at
  T = 1; the window primitives gather from device-resident tables and sum
  per cell on the device. The reference pads windows to powers of two to
  bound JAX retraces; eager PyTorch has nothing to retrace, so nothing is
  padded. Calibrators richer than a temperature stay on the device too:
  they apply to their rows there and the block gates at T = 1. (The
  reference sends them to the host because its jitted path takes a scalar
  T; the port has no such limit.)

* `CompiledGateBackend` (``"compiled"``, `repro_torch.fleet.compiled`) --
  ``"torch"`` under another name, which routes `run_fleet` to the
  compiled fleet simulator: the whole window pipeline as one program on
  the backend's device.

Consumers select a backend per run: `OffloadPlan.gate_block(...,
backend=)`, `PlanBank.gate_block(..., backend=)`, `GateTable(...,
backend=)` and `ControllerCore(..., backend=)`. None resolves to
``"torch"``, whose inputs follow the port's device rule: a tensor stays on
its device, anything else lands on the backend's `device` (``cuda``
unless the backend was made with ``device="cpu"``), and without a GPU and
without a named device the gate raises.

Numerics: both backends run the same float32 gate statistics; K1 gives
conf = 1/S where the plain version gives max(exp(logp)), about 1e-7
apart, so a sample whose confidence lies within 1e-6 of ``p_tar`` can flip
between them. Tables stay float64 on both, so the window decisions agree
exactly on the same table.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import as_tensor, resolve_device, to_numpy
from repro_torch.core.exits import gate_statistics

#: context id used when a core has no drift axis (plain logits, no schedule)
STATIC_CONTEXT = "__all__"


def _host(x) -> torch.Tensor:
    """A CPU tensor of `x` (copied off the card if it lives there)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.as_tensor(np.asarray(x))


def _block(conf, pred) -> Tuple[np.ndarray, np.ndarray]:
    return to_numpy(conf).astype(np.float64), to_numpy(pred).astype(np.int64)


def _scalar_temperature(state) -> Optional[float]:
    if state.kind == "identity":
        return 1.0
    if state.kind == "temperature":
        return float(state.params["temperature"])
    return None


# ------------------------------------------------------------- the backends
class GateBackend:
    """Evaluates gate blocks and whole arrival windows.

    Block primitives (`plan_gate_block`, `bank_gate_block`) produce the
    per-sample (confidence, prediction) arrays every consumer thresholds;
    window primitives (`window_gate`, `window_gate_cells`) evaluate a
    precomputed dense table over an arrival window's (context, sample)
    indices, the fleet simulator's inner loop. `device` is where the
    backend gates: the host unless a subclass says otherwise.
    """

    name: str = "base"
    device = torch.device("cpu")

    # ------------------------------------------------------- block level
    def plan_gate_block(
        self, plan, exit_logits, branch: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def bank_gate_block(
        self, bank, exit_logits, expert_ids: np.ndarray,
        branch: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    # ------------------------------------------------------ window level
    def window_gate(
        self, conf_table, pred_table, ctx_ids, samples, branch_idx: int,
        p_tar: float,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (confidence, prediction, on_device) for one cell's window."""
        raise NotImplementedError

    def window_gate_cells(
        self, conf_table, pred_table, ctx_ids, samples, cell_ids,
        branch_idx_by_cell, p_tar_by_cell, n_cells: int,
    ):
        """Whole-fleet window: every cell's arrivals in one evaluation.

        -> dict with per-sample ``confidence``/``prediction``/``on_device``
        plus the per-cell segment reductions ``on_count``/``offload_count``
        (shape (n_cells,)) -- the telemetry-facing sums computed inside
        the same pass that gates.
        """
        raise NotImplementedError

    def as_table(self, array):
        """Backend-resident view of a dense gate table (host numpy in,
        whatever the backend gathers from out)."""
        return array


class NumpyGateBackend(GateBackend):
    """The host path: every gate statistic on a CPU tensor (K1's plain
    version), every window lookup a numpy fancy-index -- the spec the
    ``"torch"`` backend is held against."""

    name = "numpy"

    def plan_gate_block(self, plan, exit_logits, branch=None):
        conf, pred, _ = gate_statistics(plan.calibrated_logits(_host(exit_logits), branch))
        return _block(conf, pred)

    def bank_gate_block(self, bank, exit_logits, expert_ids, branch=None):
        z = to_numpy(exit_logits)
        expert_ids = np.asarray(expert_ids, np.int64)
        keys = bank.contexts
        conf = np.empty(z.shape[0], np.float64)
        pred = np.empty(z.shape[0], np.int64)
        for eid in np.unique(expert_ids):
            plan = bank.plan_for(keys[eid]) if eid >= 0 else bank.default_plan
            m = expert_ids == eid
            c, p = self.plan_gate_block(plan, z[m], branch=branch)
            conf[m], pred[m] = c, p
        return conf, pred

    def window_gate(self, conf_table, pred_table, ctx_ids, samples,
                    branch_idx, p_tar):
        conf = conf_table[ctx_ids, branch_idx, samples]
        pred = pred_table[ctx_ids, branch_idx, samples]
        return conf, pred, conf >= p_tar

    def window_gate_cells(self, conf_table, pred_table, ctx_ids, samples,
                          cell_ids, branch_idx_by_cell, p_tar_by_cell,
                          n_cells):
        cell_ids = np.asarray(cell_ids, np.int64)
        bi = np.asarray(branch_idx_by_cell, np.int64)[cell_ids]
        conf = conf_table[ctx_ids, bi, samples]
        pred = pred_table[ctx_ids, bi, samples]
        on = conf >= np.asarray(p_tar_by_cell, np.float64)[cell_ids]
        on_count = np.bincount(cell_ids, weights=on, minlength=n_cells)
        total = np.bincount(cell_ids, minlength=n_cells)
        return {
            "confidence": conf,
            "prediction": pred,
            "on_device": on,
            "on_count": on_count.astype(np.int64),
            "offload_count": (total - on_count).astype(np.int64),
        }


class TorchGateBackend(GateBackend):
    """Gate blocks as K1 launches and window lookups as device gathers.

    A bank block with K distinct experts costs one K1 launch, as a plain
    plan block does (the host path pays one call per expert). Tables
    (`as_table`) live on `device` as float64 / int64 tensors; window
    results come back as host numpy, as every consumer thresholds and
    accounts on the host.
    """

    name = "torch"

    def __init__(self, device=None):
        self._device = device

    @property
    def device(self) -> torch.device:
        return resolve_device(self._device)

    def _index(self, x, device) -> torch.Tensor:
        return as_tensor(x, device).to(device=device, dtype=torch.int64)

    # ------------------------------------------------------- block level
    def plan_gate_block(self, plan, exit_logits, branch=None):
        z = as_tensor(exit_logits, self._device)
        t = _scalar_temperature(plan._state_for(branch))
        if t is None:  # richer calibrator: apply on the device, gate at T=1
            conf, pred, _ = gate_statistics(plan.calibrated_logits(z, branch))
        else:
            conf, pred, _ = gate_statistics(z, t)
        return _block(conf, pred)

    def bank_gate_block(self, bank, exit_logits, expert_ids, branch=None):
        keys = bank.contexts
        plans = [bank.plan_for(k) for k in keys] + [bank.default_plan]
        temps = [_scalar_temperature(p._state_for(branch)) for p in plans]
        z = as_tensor(exit_logits, self._device).to(torch.float32)
        expert_ids = np.asarray(expert_ids, np.int64)
        # -1 (unknown -> default plan) maps onto the appended last slot
        slots = np.where(expert_ids >= 0, expert_ids, len(keys))
        idx = self._index(slots, z.device)
        t = torch.tensor([1.0 if v is None else v for v in temps],
                         dtype=torch.float32, device=z.device)[idx]
        z = z / t[:, None]
        # experts whose calibrator is richer than a temperature (T=1 above)
        # apply to their own rows, still on the device
        for s in np.unique(slots):
            if temps[s] is None:
                m = idx == int(s)
                z[m] = plans[s].calibrated_logits(z[m], branch)
        conf, pred, _ = gate_statistics(z)
        return _block(conf, pred)

    # ------------------------------------------------------ window level
    def as_table(self, array):
        return as_tensor(array, self._device)

    def window_gate(self, conf_table, pred_table, ctx_ids, samples,
                    branch_idx, p_tar):
        conf_t = self.as_table(conf_table)
        dev = conf_t.device
        ctx, smp = self._index(ctx_ids, dev), self._index(samples, dev)
        conf = conf_t[ctx, int(branch_idx), smp]
        pred = self.as_table(pred_table)[ctx, int(branch_idx), smp]
        return to_numpy(conf), to_numpy(pred), to_numpy(conf >= float(p_tar))

    def window_gate_cells(self, conf_table, pred_table, ctx_ids, samples,
                          cell_ids, branch_idx_by_cell, p_tar_by_cell,
                          n_cells):
        conf_t = self.as_table(conf_table)
        dev = conf_t.device
        cells = self._index(cell_ids, dev)
        ctx, smp = self._index(ctx_ids, dev), self._index(samples, dev)
        bi = self._index(np.asarray(branch_idx_by_cell, np.int64), dev)[cells]
        conf = conf_t[ctx, bi, smp]
        pred = self.as_table(pred_table)[ctx, bi, smp]
        p_tar = torch.as_tensor(np.asarray(p_tar_by_cell, np.float64), device=dev)
        on = conf >= p_tar.to(conf.dtype)[cells]
        on_count = torch.zeros(int(n_cells), dtype=torch.int64, device=dev)
        on_count.index_add_(0, cells, on.to(torch.int64))
        total = torch.bincount(cells, minlength=int(n_cells))
        return {
            "confidence": to_numpy(conf),
            "prediction": to_numpy(pred),
            "on_device": to_numpy(on),
            "on_count": to_numpy(on_count),
            "offload_count": to_numpy(total - on_count),
        }


# -------------------------------------------------------------- registry
def _compiled_backend_factory() -> GateBackend:
    # lazy: repro_torch.fleet imports this module
    from repro_torch.fleet.compiled import CompiledGateBackend

    return CompiledGateBackend()


_GATE_BACKENDS: Dict[str, Callable[[], GateBackend]] = {
    "numpy": NumpyGateBackend,
    "torch": TorchGateBackend,
    "compiled": _compiled_backend_factory,
}
_INSTANCES: Dict[str, GateBackend] = {}


def register_gate_backend(name: str, factory: Callable[[], GateBackend]) -> None:
    _GATE_BACKENDS[name] = factory
    _INSTANCES.pop(name, None)


def available_gate_backends() -> List[str]:
    return sorted(_GATE_BACKENDS)


def get_gate_backend(backend=None) -> GateBackend:
    """Resolve a backend instance from None (-> ``"torch"``, the card: the
    port's device rule), a registered name, or an instance (passed
    through)."""
    if backend is None:
        backend = "torch"
    if isinstance(backend, GateBackend):
        return backend
    if backend not in _GATE_BACKENDS:
        raise ValueError(
            f"unknown gate backend {backend!r} "
            f"(registered: {available_gate_backends()})"
        )
    if backend not in _INSTANCES:
        _INSTANCES[backend] = _GATE_BACKENDS[backend]()
    return _INSTANCES[backend]


# ----------------------------------------------------- the dense gate table
class GateTable:
    """Precomputed per-(context, branch) gate blocks under per-sample
    expert selection -- the fleet's batched analogue of the serving cores.

    exit_logits_by_context: {context: {physical_branch: (N, C) logits}};
    final_logits_by_context the matching cloud main heads. For the
    non-drifting case pass ``{STATIC_CONTEXT: {...}}`` (or use
    `GateTable.from_logits`).

    plan_or_bank decides calibration: a single `OffloadPlan` applies one
    calibrator set everywhere; a `PlanBank` picks each sample's expert --
    via its embedded estimator on `features_by_context` (the honest
    edge-side path; unknown verdicts fall back to the default plan) or by
    the true context (oracle bound).

    The precompute gathers, per (true context, branch), each sample's
    confidence under ITS expert plan into one dense (n_ctx, n_branch, N)
    array, so the runtime cost of a window is one fancy-index + compare.
    Both the precompute and the window lookups route through the selected
    `GateBackend` (``"torch"`` keeps the tables on the card and gates a
    window in one gather; ``"numpy"`` is the host spec).
    """

    def __init__(
        self,
        exit_logits_by_context: Dict[str, Dict[int, np.ndarray]],
        final_logits_by_context: Dict[str, np.ndarray],
        plan_or_bank,
        labels: Optional[np.ndarray] = None,
        features_by_context: Optional[Dict[str, np.ndarray]] = None,
        backend=None,
    ):
        from repro_torch.core.bank import PlanBank

        self.backend = get_gate_backend(backend)
        if isinstance(plan_or_bank, PlanBank):
            self.bank: Optional[PlanBank] = plan_or_bank
            self.plan = plan_or_bank.default_plan
            criteria = {p.criterion for p in plan_or_bank.plans.values()}
        else:
            self.bank = None
            self.plan = plan_or_bank
            criteria = {plan_or_bank.criterion}
        if criteria != {"confidence"}:
            # every expert, not just the default, so the fleet cannot
            # silently serve a bank the event runtime would reject
            raise ValueError(
                "the fleet gate thresholds the runtime's moving confidence "
                f"target; plan criteria {sorted(criteria)} are not supported"
            )
        self.ctx_keys: List[str] = sorted(exit_logits_by_context)
        self.ctx_index = {k: i for i, k in enumerate(self.ctx_keys)}
        if set(final_logits_by_context) != set(self.ctx_keys):
            raise ValueError("exit and final logits must cover the same contexts")
        self.branches = sorted(next(iter(exit_logits_by_context.values())))
        self._branch_index = {b: i for i, b in enumerate(self.branches)}
        for ctx, per_branch in exit_logits_by_context.items():
            if sorted(per_branch) != self.branches:
                raise ValueError(f"context {ctx!r} covers different branches")
        n = len(final_logits_by_context[self.ctx_keys[0]])
        self.n_samples = n

        # per-(ctx, sample) expert selection: estimator verdicts on real
        # features when available, oracle else
        self._oracle = not (
            self.bank is not None
            and self.bank.estimator is not None
            and features_by_context is not None
        )
        bank_keys = self.bank.contexts if self.bank is not None else []
        # est ids index into bank_keys; -1 = unknown verdict; whole array
        # None in oracle mode (no estimator to report in telemetry)
        self._est_ids: Optional[np.ndarray] = None
        if not self._oracle:
            est = self.bank.estimator
            est_ids = np.empty((len(self.ctx_keys), n), np.int64)
            key_to_bank = {k: i for i, k in enumerate(bank_keys)}
            est_to_bank = np.asarray(
                [key_to_bank[k] for k in est.contexts], np.int64
            )
            for ci, ctx in enumerate(self.ctx_keys):
                if ctx not in features_by_context:
                    raise ValueError(f"no features for context {ctx!r}")
                ids = est.predict_ids(features_by_context[ctx])
                est_ids[ci] = np.where(ids >= 0, est_to_bank[ids], -1)
            self._est_ids = est_ids

        self.conf = np.empty((len(self.ctx_keys), len(self.branches), n))
        self.pred = np.empty_like(self.conf, dtype=np.int64)
        for ci, ctx in enumerate(self.ctx_keys):
            for bi, b in enumerate(self.branches):
                z = exit_logits_by_context[ctx][b]
                if self.bank is None:
                    c, p = self.backend.plan_gate_block(
                        self.plan, z, branch=b - 1
                    )
                elif self._oracle:
                    eids = np.full(
                        n, bank_keys.index(ctx) if ctx in bank_keys else -1,
                        np.int64,
                    )
                    c, p = self.backend.bank_gate_block(
                        self.bank, z, eids, branch=b - 1
                    )
                else:
                    c, p = self.backend.bank_gate_block(
                        self.bank, z, self._est_ids[ci], branch=b - 1
                    )
                self.conf[ci, bi], self.pred[ci, bi] = c, p
        self._final_logits = {
            k: to_numpy(final_logits_by_context[k]) for k in self.ctx_keys
        }
        self.final_pred = np.stack(
            [np.argmax(self._final_logits[k], axis=-1) for k in self.ctx_keys]
        ).astype(np.int64)
        # the codec's per-level cloud tables are computed lazily in
        # `cloud_pred` -- a level-0-only run never touches them
        self._final_pred_by_level: Dict[int, np.ndarray] = {0: self.final_pred}
        self.labels = None if labels is None else np.asarray(labels, np.int64)
        self.bank_keys = bank_keys
        # backend-resident views (device tensors for the torch backend)
        # used by the window lookups; host numpy stays the source of truth
        self._conf_t = self.backend.as_table(self.conf)
        self._pred_t = self.backend.as_table(self.pred)

    @classmethod
    def from_logits(
        cls,
        exit_logits: Dict[int, np.ndarray],
        final_logits: np.ndarray,
        plan,
        labels: Optional[np.ndarray] = None,
        backend=None,
    ) -> "GateTable":
        """Non-drifting table over one logit set (the `LogitsCore` case)."""
        return cls({STATIC_CONTEXT: exit_logits}, {STATIC_CONTEXT: final_logits},
                   plan, labels=labels, backend=backend)

    # ------------------------------------------------------- window lookups
    def branch_idx(self, branch: int) -> int:
        if branch not in self._branch_index:
            raise ValueError(
                f"branch {branch} not served (table covers {self.branches})"
            )
        return self._branch_index[branch]

    def gate(self, ctx_ids: np.ndarray, samples: np.ndarray, branch: int):
        """-> (confidence, edge prediction) for a whole window."""
        bi = self.branch_idx(branch)
        return self.conf[ctx_ids, bi, samples], self.pred[ctx_ids, bi, samples]

    def gate_window(
        self, ctx_ids: np.ndarray, samples: np.ndarray, branch: int,
        p_tar: float,
    ):
        """-> (confidence, prediction, on_device) through the backend --
        what the fleet simulator thresholds per (cell, window)."""
        return self.backend.window_gate(
            self._conf_t, self._pred_t, ctx_ids, samples,
            self.branch_idx(branch), p_tar,
        )

    def gate_window_cells(
        self, ctx_ids, samples, cell_ids, branch_by_cell, p_tar_by_cell,
        n_cells: int,
    ):
        """Whole-fleet window in one backend call (+ per-cell on/offload
        segment counts); `branch_by_cell` holds PHYSICAL branch numbers."""
        bi = np.asarray([self.branch_idx(int(b)) for b in branch_by_cell],
                        np.int64)
        return self.backend.window_gate_cells(
            self._conf_t, self._pred_t, ctx_ids, samples, cell_ids, bi,
            np.asarray(p_tar_by_cell, np.float64), n_cells,
        )

    def cloud_pred(
        self, ctx_ids: np.ndarray, samples: np.ndarray, level: int = 0
    ) -> np.ndarray:
        """Cloud (main-head) predictions for a window. `level` is the
        payload codec level the offload shipped at: the main head then
        sees the activation after a codec round-trip, modeled here by
        round-tripping the stored final logits through the codec on the
        backend's device (K3/K4 on the card; level 0 stays the untouched
        table)."""
        from repro_torch.kernels.compress import roundtrip

        level = int(level)
        if level not in self._final_pred_by_level:
            self._final_pred_by_level[level] = np.stack(
                [
                    np.argmax(to_numpy(roundtrip(self._final_logits[k], level,
                                                 device=self.backend.device)), axis=-1)
                    for k in self.ctx_keys
                ]
            ).astype(np.int64)
        return self._final_pred_by_level[level][ctx_ids, samples]

    def est_ids(self, ctx_ids: np.ndarray, samples: np.ndarray) -> Optional[np.ndarray]:
        """Estimator verdicts (indices into `bank_keys`, -1 unknown) for a
        window; None when selection is oracle/single-plan."""
        if self._est_ids is None:
            return None
        return self._est_ids[ctx_ids, samples]

    def correct(self, samples: np.ndarray, preds: np.ndarray) -> Optional[np.ndarray]:
        if self.labels is None:
            return None
        return self.labels[samples] == preds
