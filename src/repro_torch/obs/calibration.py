"""Streaming calibration-health sketches: mergeable reliability bins.

Port of `repro.obs.calibration` (host numpy only).

The paper's core failure mode -- miscalibrated confidence silently
corrupting offload decisions -- is invisible to the coarse
``|on-device acc - p_tar|`` gap until accuracy has already been lost.
The real diagnostic is the reliability diagram (`repro_torch.core.metrics`),
which until this module existed only as an offline helper over full
logit arrays. `ReliabilitySketch` makes it STREAMING: a fixed-size
per-(cell, context, branch) bin sketch that every serving stack can
update online (per request in `ServingRuntime`, per window in the
`FleetSimulator`) and that merges EXACTLY -- elementwise addition -- so
per-cell sketches roll up to fleet regimes without touching raw
samples.

Binning reproduces `repro_torch.core.metrics.ece` bit-for-bit: ``B`` equal
bins over (0, 1], each left-open/right-closed, assigned by
``searchsorted(edges, conf, side='left') - 1`` on the SAME float64
edges on every backend (binary search is exact, so host numpy and the
jitted path agree bin-for-bin). Confidences <= 0 fall outside every
ece bin but still count toward its denominator; they land in a
dedicated overflow slot (column ``B``) so totals stay conserved.

Each (cell, context, branch) key holds a ``(7, B+1)`` float64 block:

    row 0  count            gated requests in the bin
    row 1  correct          edge-prediction correctness sum
    row 2  conf_sum         sum of gate confidences
    row 3  conf_sq_sum      sum of squared confidences (Brier)
    row 4  conf_correct_sum sum of conf * correct (Brier cross term)
    row 5  on_count         requests the gate kept on-device
    row 6  on_correct       on-device requests that were correct

plus a per-cell ``ungated`` counter for requests that never saw a gate
(backhaul routing during an outage) so that a sketch's total equals
the `fleet_requests_total` counter -- an invariant `repro_torch.obs.check`
cross-examines. Derived gauges (windowed ECE, coverage = on-device
precision, Brier score, per-bin conf-vs-acc residual) are pure
functions of a block, shared with the live QoS estimator.
"""
from __future__ import annotations

import bisect
import json
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

N_BINS = 15
_ROWS = 7
#: context key used by single-context serving stacks (matches
#: `repro_torch.core.gatepath.GateTable.STATIC_CONTEXT`)
GLOBAL_CONTEXT = "__all__"


def bin_edges(n_bins: int = N_BINS) -> np.ndarray:
    """The float64 bin edges every backend must share. Identical values
    feed every `np.searchsorted` (and the compiled fleet program's
    search, once ported), so bin assignment is exact everywhere."""
    return np.linspace(0.0, 1.0, n_bins + 1)


def bin_index(conf: np.ndarray, n_bins: int = N_BINS) -> np.ndarray:
    """Bin ids for `conf`: bin b covers (edges[b], edges[b+1]] exactly as
    `core.metrics.ece` masks it; conf <= 0 maps to the overflow slot
    `n_bins` (counted in totals, excluded from every ECE bin)."""
    idx = np.searchsorted(bin_edges(n_bins), conf, side="left") - 1
    return np.where(idx < 0, n_bins, idx).astype(np.int64)


def bin_block(
    conf: np.ndarray,
    correct: np.ndarray,
    on: np.ndarray,
    n_bins: int = N_BINS,
) -> np.ndarray:
    """Accumulate raw gate outcomes into one ``(7, n_bins+1)`` block --
    the shared binning core for sketch updates and the live windowed
    QoS estimate."""
    conf = np.asarray(conf, np.float64)
    correct = np.asarray(correct, np.float64)
    on = np.asarray(on, np.float64)
    idx = bin_index(conf, n_bins)
    block = np.empty((_ROWS, n_bins + 1), np.float64)
    for r, w in enumerate((
        np.ones_like(conf), correct, conf, conf * conf, conf * correct,
        on, on * correct,
    )):
        block[r] = np.bincount(idx, weights=w, minlength=n_bins + 1)
    return block


def block_ece(block: np.ndarray, total: Optional[float] = None) -> float:
    """Expected calibration error of a block: sum_b (n_b/N) |acc_b -
    mean_conf_b| over the real bins, N = all gated requests (overflow
    slot included in the denominator, exactly like `core.metrics.ece`).
    NaN when the block is empty."""
    n_bins = block.shape[1] - 1
    n_b = block[0, :n_bins]
    n = float(block[0].sum()) if total is None else float(total)
    if n <= 0:
        return float("nan")
    m = n_b > 0
    acc = block[1, :n_bins][m] / n_b[m]
    conf = block[2, :n_bins][m] / n_b[m]
    return float(np.sum(n_b[m] / n * np.abs(acc - conf)))


def block_coverage(block: np.ndarray) -> float:
    """Fraction of on-device exits (confidence cleared p_tar) that were
    correct -- the precision the gate promised >= p_tar. NaN when
    nothing stayed on-device."""
    on = float(block[5].sum())
    return float(block[6].sum() / on) if on > 0 else float("nan")


def block_brier(block: np.ndarray) -> float:
    """Mean squared error of confidence vs correctness, from the three
    accumulated moments. NaN on an empty block."""
    n = float(block[0].sum())
    if n <= 0:
        return float("nan")
    return float(
        (block[3].sum() - 2.0 * block[4].sum() + block[1].sum()) / n
    )


def block_reliability(block: np.ndarray) -> List[dict]:
    """Per-bin reliability rows for non-empty bins: mean confidence,
    accuracy, count, and the signed conf-vs-acc residual (positive =
    overconfident). The overflow slot is skipped (no defined bin)."""
    n_bins = block.shape[1] - 1
    rows = []
    edges = bin_edges(n_bins)
    for b in range(n_bins):
        n = block[0, b]
        if n <= 0:
            continue
        conf = block[2, b] / n
        acc = block[1, b] / n
        rows.append({
            "bin": b,
            "lo": float(edges[b]),
            "hi": float(edges[b + 1]),
            "count": int(n),
            "mean_conf": float(conf),
            "accuracy": float(acc),
            "residual": float(conf - acc),
        })
    return rows


Key = Tuple[int, str, int]  # (cell, context, branch)


class ReliabilitySketch:
    """Mergeable windowed reliability-bin sketch keyed by
    (cell, context, branch). All updates are pure accumulation, so
    ``merge`` (elementwise add) is exact and order-independent --
    per-cell sketches built by different backends roll up identically.
    """

    def __init__(self, n_bins: int = N_BINS):
        if n_bins < 1:
            raise ValueError("n_bins must be >= 1")
        self.n_bins = int(n_bins)
        self._blocks: Dict[Key, np.ndarray] = {}
        self._ungated: Dict[int, int] = {}
        # plain-float copy of the shared edges: `bisect` over these is
        # the same binary search as `np.searchsorted(side="left")` on
        # the identical float64 values, minus the per-call array setup
        self._edges: List[float] = [float(e) for e in bin_edges(self.n_bins)]

    # ------------------------------------------------------------ updates
    def update(
        self,
        cell: int,
        context: str,
        branch: int,
        conf: np.ndarray,
        correct: np.ndarray,
        on: np.ndarray,
    ) -> None:
        """Accumulate a batch of gate outcomes for one key. `conf` are
        gate confidences, `correct` the EDGE prediction's correctness
        (0/1 -- captured at gate time, before any cloud answer patches
        it), `on` whether the gate kept the request on-device."""
        block = bin_block(conf, correct, on, self.n_bins)
        key = (int(cell), str(context), int(branch))
        have = self._blocks.get(key)
        if have is None:
            self._blocks[key] = block
        else:
            have += block

    def update_one(self, cell: int, context: str, branch: int,
                   conf: float, correct: float, on: bool) -> None:
        """Scalar fast path for a single gate outcome -- the event-driven
        serving runtime records one request at a time, where routing
        through `bin_block` would pay seven one-element bincounts per
        request. Bin assignment and the per-bin additions are identical
        to `update`, so the resulting block is bit-for-bit the same."""
        c = float(conf)
        idx = bisect.bisect_left(self._edges, c) - 1
        if idx < 0 or idx >= self.n_bins:
            idx = self.n_bins
        key = (int(cell), str(context), int(branch))
        block = self._blocks.get(key)
        if block is None:
            block = np.zeros((_ROWS, self.n_bins + 1), np.float64)
            self._blocks[key] = block
        k = float(correct)
        o = 1.0 if on else 0.0
        col = block[:, idx]
        col[0] += 1.0
        col[1] += k
        col[2] += c
        col[3] += c * c
        col[4] += c * k
        col[5] += o
        col[6] += o * k

    def update_binned(self, cell: int, context: str, branch: int,
                      block: np.ndarray) -> None:
        """Accumulate a pre-binned ``(7, n_bins+1)`` block -- the entry
        point for a backend that bins whole windows at once (the
        compiled fleet simulator of the reference)."""
        block = np.asarray(block, np.float64)
        if block.shape != (_ROWS, self.n_bins + 1):
            raise ValueError(
                f"block shape {block.shape} != ({_ROWS}, {self.n_bins + 1})"
            )
        key = (int(cell), str(context), int(branch))
        have = self._blocks.get(key)
        if have is None:
            self._blocks[key] = block.copy()
        else:
            have += block

    def note_ungated(self, cell: int, n: int) -> None:
        """Count `n` requests served WITHOUT a gate decision (backhaul
        routing while a cell is down). They carry no calibration signal
        but must be counted for sketch totals to match
        `fleet_requests_total`."""
        if n:
            c = int(cell)
            self._ungated[c] = self._ungated.get(c, 0) + int(n)

    def merge(self, other: "ReliabilitySketch") -> "ReliabilitySketch":
        """Exact in-place merge (elementwise add); returns self."""
        if other.n_bins != self.n_bins:
            raise ValueError("cannot merge sketches with different n_bins")
        for key, block in other._blocks.items():
            have = self._blocks.get(key)
            if have is None:
                self._blocks[key] = block.copy()
            else:
                have += block
        for c, n in other._ungated.items():
            self._ungated[c] = self._ungated.get(c, 0) + n
        return self

    # ------------------------------------------------------------ queries
    def __len__(self) -> int:
        return len(self._blocks)

    def keys(self) -> List[Key]:
        return sorted(self._blocks)

    def block(self, cell: int, context: str, branch: int) -> np.ndarray:
        return self._blocks[(int(cell), str(context), int(branch))]

    def merged_block(
        self,
        cell: Optional[int] = None,
        context: Optional[str] = None,
        branch: Optional[int] = None,
    ) -> np.ndarray:
        """Sum of all blocks matching the given key components (None =
        wildcard) -- the exact-merge property in query form."""
        out = np.zeros((_ROWS, self.n_bins + 1), np.float64)
        for (c, ctx, b), block in self._blocks.items():
            if cell is not None and c != cell:
                continue
            if context is not None and ctx != context:
                continue
            if branch is not None and b != branch:
                continue
            out += block
        return out

    def cells(self) -> List[int]:
        got = {c for c, _, _ in self._blocks}
        got.update(self._ungated)
        return sorted(got)

    def contexts(self) -> List[str]:
        return sorted({ctx for _, ctx, _ in self._blocks})

    def gated_count(self, cell: Optional[int] = None) -> int:
        return int(round(self.merged_block(cell=cell)[0].sum()))

    def ungated_count(self, cell: Optional[int] = None) -> int:
        if cell is None:
            return sum(self._ungated.values())
        return self._ungated.get(int(cell), 0)

    def total_count(self, cell: Optional[int] = None) -> int:
        """Gated + ungated requests -- must equal the request counters
        the serving stacks maintain (`repro_torch.obs.check` asserts it)."""
        return self.gated_count(cell) + self.ungated_count(cell)

    def ece(self, cell: Optional[int] = None,
            context: Optional[str] = None,
            branch: Optional[int] = None) -> float:
        return block_ece(self.merged_block(cell, context, branch))

    def coverage(self, cell: Optional[int] = None,
                 context: Optional[str] = None,
                 branch: Optional[int] = None) -> float:
        return block_coverage(self.merged_block(cell, context, branch))

    def brier(self, cell: Optional[int] = None,
              context: Optional[str] = None,
              branch: Optional[int] = None) -> float:
        return block_brier(self.merged_block(cell, context, branch))

    def reliability(self, cell: Optional[int] = None,
                    context: Optional[str] = None,
                    branch: Optional[int] = None) -> List[dict]:
        return block_reliability(self.merged_block(cell, context, branch))

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {
            "n_bins": self.n_bins,
            "blocks": [
                {"cell": c, "context": ctx, "branch": b,
                 "data": self._blocks[(c, ctx, b)].tolist()}
                for c, ctx, b in self.keys()
            ],
            "ungated": {str(c): n for c, n in sorted(self._ungated.items())},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ReliabilitySketch":
        sk = cls(n_bins=int(d["n_bins"]))
        for rec in d["blocks"]:
            sk.update_binned(rec["cell"], rec["context"], rec["branch"],
                             np.asarray(rec["data"], np.float64))
        for c, n in d.get("ungated", {}).items():
            sk.note_ungated(int(c), int(n))
        return sk

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "ReliabilitySketch":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def merge_sketches(
    sketches: Iterable[ReliabilitySketch],
) -> ReliabilitySketch:
    """Merge independent sketches into a fresh one (exact, associative)."""
    out: Optional[ReliabilitySketch] = None
    for sk in sketches:
        if out is None:
            out = ReliabilitySketch(n_bins=sk.n_bins)
        out.merge(sk)
    return out if out is not None else ReliabilitySketch()
