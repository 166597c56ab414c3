"""Compiled fleet pipeline: the whole window loop as one float64 torch
program on one device.

`FleetSimulator.run` steps the fleet in host numpy: a Python loop over
(window, cell) batches, each doing a handful of small vectorized solves
and one gate lookup. This module moves the full pipeline -- per-device
FIFO edge queues -> context lookup -> gate -> per-cell uplink (with
Markov/trace link repricing) -> the shared K-server cloud tier -- into
one program over tensors with a leading cell axis, on the gate backend's
device:

* every FIFO recurrence is `maxplus.maxplus_fifo`'s closed form along the
  innermost axis: the edge lanes as (cells, rows), the uplink batches as
  (cells, batch rows), the cloud tier's K residue chains as (K, jobs/K);
* windows need no host loop: window boundaries only decide BATCH
  MEMBERSHIP (which uplink batch a request joins) and the per-batch link
  repricing order, so the host precomputes the (window, origin) ->
  serving-cell batch layout (churn shed routing included, which is pure
  time-based) and the program walks each cell's batch sequence in one
  loop vectorized over cells -- that loop IS the window loop, fused;
* the `GateTable` conf block and the materialized context/network tables
  are copied up once; the program syncs once, and its columns come back
  once.

Parity contract (`tests/test_torch_fleet_compiled.py`, `chip_smoke.py`
phase 10): against the host simulator on the same table, every
integer/bool column (gate decision, context id, estimator verdict,
correctness, shed routing, churn accounting) matches EXACTLY -- the gate
compares the same float64 table values against the same threshold --
while latency columns match to float round-off (the chains run as whole
lanes, not per window, and the card's scans round in their own order).
The reliability sketch's count rows are integers and match exactly; its
confidence sums are added in another order (and atomically on the card)
and match to round-off.

Scope: a STATIC deployment (no mid-run controller rescoring, no canary
rollout -- both mutate per-window state the fused program has already
consumed; use the host backends for those). Churn shed/backhaul, cloud
brownouts, the QoS monitor, and obs trace/audit/metrics emission are
supported: the program returns the per-request columns and the host
replays the boundary bookkeeping (orchestrator hooks, live QoS view,
sampled traces) from them, operation for operation in the host
simulator's order.

Port of `repro.fleet.compiled`. The reference jits the program with
`vmap` (and `shard_map` over a cell mesh) under `enable_x64`; here cells
are the leading axis of float64 / int64 tensors, and eager torch has
nothing to retrace, so nothing is cached or padded to powers of two.

Over a ``"cells"`` mesh of ranks (`sharding.fleet_mesh`, W ranks of a
`torch.distributed` launch, each with the whole table) each rank runs
the per-cell stages, the edge tier and the uplink, on its contiguous
block of C/W cells; the columns are then gathered along the cell axis
(`launch.mesh.gather_blocks`, an all-reduce), and the shared cloud tier,
the sketch and the host replay run on the whole fleet on every rank, as
the reference's `shard_map` covers its per-cell function only. Every
rank returns the same telemetry; `host_s` and `stage_ms` are rank 0's.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import as_tensor
from repro_torch.core.gatepath import GateTable, TorchGateBackend
from repro_torch.fleet.maxplus import maxplus_fifo
from repro_torch.fleet.simulator import FleetConfig, FleetSimulator, _LiveCloud
from repro_torch.fleet.telemetry import FleetTelemetry
from repro_torch.fleet.topology import FleetTopology
from repro_torch.launch.mesh import MeshSpec, all_sum, gather_blocks
from repro_torch.obs.calibration import bin_edges
from repro_torch.offload import latency as L
from repro_torch.serving.drift import MarkovContextSchedule, PiecewiseSchedule
from repro_torch.serving.network import FixedRateNetwork, MarkovNetwork, TraceNetwork

__all__ = ["CompiledGateBackend", "CompiledFleetSimulator"]

_BIG_DWELL = 1e18  # one-slot "slotted" table: floor(t / BIG) == 0 for any t


class CompiledGateBackend(TorchGateBackend):
    """Backend marker that routes `run_fleet` to the compiled simulator.

    Table blocks are K1 launches and the float64 conf table lives on
    `device`, exactly as under ``"torch"`` (this class IS
    `TorchGateBackend` plus a name), so gate decisions on the compiled
    path equal a host ``"torch"`` run on the same table; what changes is
    WHERE the fleet pipeline runs -- see `CompiledFleetSimulator`.
    """

    name = "compiled"


@dataclass
class _Batch:
    """One (window, origin-cell) arrival batch and where it serves."""

    w: int
    origin: int
    serve: int  # serving cell, or -1 = whole-fleet-outage cloud backhaul
    lo: int
    hi: int
    shed: bool
    row0: int = 0  # start row in the serving cell's lane (or backhaul lane)
    blocal: int = 0  # batch index within the serving cell's lane


def _check_scope(controller: bool, orchestrator) -> None:
    if controller:
        raise ValueError(
            "the compiled fleet pipeline serves a static deployment; "
            "run the controller on the host backend "
            "(backend='torch' or 'numpy')"
        )
    if orchestrator is not None and getattr(orchestrator, "rollout", None) is not None:
        raise ValueError(
            "the compiled fleet pipeline does not support canary "
            "rollouts (per-window table swaps); use the host backend"
        )


# ------------------------------------------------------------ device program
def _ctx_at(tbl, org, t):
    """Table context ids in force at `t` under cell `org`'s regime (both
    tensors of one shape), as `FleetSimulator._ctx_ids` looks them up:
    numpy's `//` into the materialized dwell slots, or the last piecewise
    knot at or before `t`."""
    tpos = t.clamp(min=0.0)
    slots = tbl["ctx_slots"]
    slot = torch.div(tpos, tbl["ctx_dwell"][org], rounding_mode="floor")
    out = slots[org, slot.clamp(0, slots.shape[1] - 1).long()]
    if tbl["ctx_any_knots"]:
        knots = tbl["ctx_knots"]
        seg = torch.searchsorted(knots[org], tpos.unsqueeze(-1), right=True).squeeze(-1) - 1
        seg = seg.clamp(0, knots.shape[1] - 1)
        out = torch.where(tbl["ctx_mode"][org] == 1, tbl["ctx_kctx"][org, seg], out)
    return out


def _rate_at(tbl, c, t):
    """Link rates of cells `c` at `t`, as the cells' `rates_bps`: numpy's
    `//` into the materialized dwell slots (a fixed link is one slot), or
    the trace segment of ``t % period`` (``np.mod``)."""
    tpos = t.clamp(min=0.0)
    slots = tbl["net_slots"]
    slot = torch.div(tpos, tbl["net_dwell"][c], rounding_mode="floor")
    out = slots[c, slot.clamp(0, slots.shape[1] - 1).long()]
    if tbl["net_any_knots"]:
        per = tbl["net_period"][c]
        looped = per > 0
        tt = torch.where(looped, torch.remainder(tpos, torch.where(looped, per, 1.0)), tpos)
        seg = torch.searchsorted(tbl["net_knots"][c], tt.unsqueeze(-1), right=True).squeeze(-1)
        seg = (seg - 1).clamp(min=0)
        out = torch.where(tbl["net_mode"][c] == 1, tbl["net_rates"][c, seg], out)
    return out


def _lexsort(keys, dim: int = -1):
    """Indices that sort along `dim` by `keys`, the LAST key primary, ties
    kept in index order: numpy's `lexsort`, as a chain of stable sorts from
    the least significant key."""
    order = None
    for k in keys:
        k = k if order is None else k.gather(dim, order)
        o = torch.argsort(k, dim=dim, stable=True)
        order = o if order is None else order.gather(dim, o)
    return order


def _scale_at(t, slowdowns):
    """Cloud brownout factors at `t`, multiplied in as the host does."""
    sc = torch.ones_like(t)
    for a, b, f in slowdowns:
        sc = torch.where((t >= a) & (t < b), sc * f, sc)
    return sc


def _edge_tier(lane, bh, tbl, n_devices: int, cell0: int = 0):
    """Edge lanes, context and gate; backhaul lanes. One masked max-plus
    chain per (cell, device): rows arrive in (window, origin) batch order,
    which is exactly the host's carried-dev_free chain order. The lanes
    are cells cell0, cell0 + 1, ... of the fleet."""
    arr, valid = lane["arr"], lane["valid"]
    srv = torch.full_like(arr, tbl["s_edge"])
    edge_done = torch.zeros_like(arr)
    for d in range(n_devices):
        m = valid & (lane["dev"] == d)
        edge_done = torch.where(m, maxplus_fifo(arr, srv, m, 0.0, dim=-1), edge_done)
    zero = torch.zeros_like(lane["org"])
    ctx = torch.where(valid, _ctx_at(tbl, lane["org"], edge_done), zero)
    conf = tbl["conf"][ctx, lane["smp"]]
    on = conf >= tbl["p_tar"]
    # whole-fleet outage: nominal-rate cloud backhaul, one chain per origin
    bh_done = maxplus_fifo(bh["arr"], torch.full_like(bh["arr"], tbl["comm_bh"]),
                           bh["valid"], 0.0, dim=-1)
    org = torch.arange(cell0, cell0 + bh["arr"].shape[0],
                       device=arr.device)[:, None].expand_as(bh["gid"])
    ctx_bh = torch.where(bh["valid"], _ctx_at(tbl, org, bh["arr"]), torch.zeros_like(org))
    return edge_done, ctx, conf, on, ctx_bh, bh_done


def _uplink(lane, tbl, edge_done, offl, n_batches: int, batch_rows: int, cell0: int = 0):
    """Per-cell uplink: offloads sorted to the front in (batch, ready-time)
    order, then each batch priced with the host's two-pass link repricing
    in a loop over batch slots, vectorized over cells (cells cell0,
    cell0 + 1, ...), carrying each cell's uplink-free time. The loop stays
    sequential: a batch's pricing reads the previous batch's free time."""
    C, R = edge_done.shape
    dev = edge_done.device
    bl = lane["bl"]
    order = _lexsort((edge_done, bl, (~offl).to(torch.uint8)))
    t_s = edge_done.gather(1, order)
    counts = torch.zeros(C, n_batches, dtype=torch.int64, device=dev)
    counts.scatter_add_(1, bl.gather(1, order), offl.gather(1, order).long())
    starts = torch.cumsum(counts, 1) - counts
    sub = torch.arange(batch_rows, device=dev)
    idx = (starts[:, :, None] + sub).clamp(max=R - 1).reshape(C, -1)  # (C, B * Rb)
    sv = (sub < counts[:, :, None]).reshape(C, n_batches, batch_rows)
    t_b = t_s.gather(1, idx).reshape(C, n_batches, batch_rows)
    cells = torch.arange(cell0, cell0 + C, device=dev)[:, None].expand(C, batch_rows)
    nbytes8 = tbl["nbytes8"]
    free = torch.zeros(C, 1, dtype=torch.float64, device=dev)
    done, comm = [], []
    for b in range(n_batches):
        t_row, m_row = t_b[:, b], sv[:, b]
        c1 = nbytes8 / _rate_at(tbl, cells, t_row)
        d1 = maxplus_fifo(t_row, c1, m_row, free, dim=-1)
        # reprice at the actual transfer start (the host's fixed-point
        # pass: rates at done - comm1)
        c2 = nbytes8 / _rate_at(tbl, cells, d1 - c1)
        d2 = maxplus_fifo(t_row, c2, m_row, free, dim=-1)
        last = torch.where(m_row, d2, -torch.inf).amax(dim=1, keepdim=True)
        free = torch.where(m_row.any(dim=1, keepdim=True), last, free)
        done.append(d2)
        comm.append(c2)
    # back to lane rows through a dump column R that is dropped
    safe = torch.where(sv.reshape(C, -1), order.gather(1, idx), R)

    def unsort(x):
        out = torch.full((C, R + 1), torch.nan, dtype=torch.float64, device=dev)
        return out.scatter_(1, safe, torch.stack(x, 1).reshape(C, -1))[:, :R]

    return unsort(done), unsort(comm)


def _cloud_tier(lane, bh, tbl, edge_done, ok_a, up_done, bh_done, k: int, slowdowns):
    """The shared cloud, solved once globally: jobs in generation order
    ((window, origin) batch, ready time, row), stably sorted by transfer
    completion, K residue-class chains as the rows of the (K, M)
    transpose of the row-major (M, K) reshape, then unsorted."""
    C, R = edge_done.shape
    dev = edge_done.device
    s_cloud = tbl["s_cloud"]
    s_a = s_cloud * _scale_at(up_done, slowdowns)
    s_b = s_cloud * _scale_at(bh_done, slowdowns)
    t = torch.cat([up_done.reshape(-1), bh_done.reshape(-1)])
    ok = torch.cat([ok_a.reshape(-1), bh["valid"].reshape(-1)])
    sv = torch.cat([s_a.reshape(-1), s_b.reshape(-1)])
    gid = torch.cat([lane["gid"].reshape(-1), bh["gid"].reshape(-1)])
    ready = torch.cat([edge_done.reshape(-1), bh["arr"].reshape(-1)])
    n = t.shape[0]
    gorder = _lexsort((ready, gid, (~ok).to(torch.uint8)))
    key_t = torch.where(ok, t, torch.inf)
    # sorting generation order stably by completion = lexsort((rank, key))
    order = gorder.gather(0, torch.argsort(key_t.gather(0, gorder), stable=True))
    pad = -(-n // k) * k - n
    t_s = torch.cat([key_t.gather(0, order), torch.full((pad,), torch.inf, device=dev,
                                                        dtype=torch.float64)])
    s_s = torch.cat([torch.where(ok, sv, 0.0).gather(0, order),
                     torch.zeros(pad, dtype=torch.float64, device=dev)])
    mat_t = t_s.reshape(-1, k).T.contiguous()
    mat_s = s_s.reshape(-1, k).T.contiguous()
    done = maxplus_fifo(mat_t, mat_s, torch.ones_like(mat_t, dtype=torch.bool), 0.0, dim=-1)
    cloud = torch.empty(n, dtype=torch.float64, device=dev)
    cloud.scatter_(0, order, done.T.reshape(-1)[:n])
    n_a = C * R
    return (s_a, cloud[:n_a].reshape(C, R), s_b, cloud[n_a:].reshape(bh_done.shape))


def _sketch(lane, tbl, ctx, conf, on, n_ctx: int, n_bins: int):
    """The reliability-bin sketch over the gated lanes, summed by (origin
    cell, context, bin) segment: the host's float64 bin edges, so
    `searchsorted` assigns the host's bins. Backhaul lanes carry no gate
    decision and are excluded (the host counts them via `note_ungated`).
    The count rows are integers in float64, exact in any order; the
    confidence sums go through `index_add_` (atomic on the card)."""
    C = ctx.shape[0]
    nb1 = n_bins + 1
    vf = lane["valid"].reshape(-1).to(torch.float64)
    ctx_f = ctx.reshape(-1)
    conf_f = conf.reshape(-1)
    ec = tbl["ecorrect"][ctx_f, lane["smp"].reshape(-1)]
    onf = on.reshape(-1).to(torch.float64)
    bins = torch.searchsorted(tbl["cal_edges"], conf_f) - 1
    bins = torch.where(bins < 0, n_bins, bins)
    seg = (lane["org"].reshape(-1) * n_ctx + ctx_f) * nb1 + bins
    rows = torch.stack([vf, ec * vf, conf_f * vf, conf_f * conf_f * vf,
                        conf_f * ec * vf, onf * vf, onf * ec * vf])
    cal = torch.zeros(7, C * n_ctx * nb1, dtype=torch.float64, device=ctx.device)
    return cal.index_add_(1, seg, rows).reshape(7, C, n_ctx, nb1)


def _gather_cells(cols, index: int, n: int, group):
    """Every rank's block of the per-cell columns, in cell order on every
    rank: one all-reduce of the columns packed as float64 (context ids and
    gate verdicts are exact there, NaN and infinities pass through).
    `cols`: edge_done, ctx, conf, on, up_done, up_comm (cells, rows) and
    ctx_bh, bh_done (cells, backhaul rows)."""
    a = torch.stack([x.to(torch.float64) for x in cols[:6]], dim=-1)
    b = torch.stack([x.to(torch.float64) for x in cols[6:]], dim=-1)
    every = gather_blocks(torch.cat([a.reshape(-1), b.reshape(-1)]), index, n, group)
    ga = [x.contiguous() for x in
          every[:, :a.numel()].reshape((-1,) + tuple(a.shape[1:])).unbind(-1)]
    gb = [x.contiguous() for x in
          every[:, a.numel():].reshape((-1,) + tuple(b.shape[1:])).unbind(-1)]
    edge_done, ctx, conf, on, up_done, up_comm = ga
    ctx_bh, bh_done = gb
    return (edge_done, ctx.to(torch.int64), conf, on.to(torch.bool), ctx_bh.to(torch.int64),
            bh_done, up_done, up_comm)


def _program(lane, bh, tbl, dims, shard=None):
    """The device program: -> (output columns on the device, [(stage, CUDA
    event recorded at its end)], empty off the card). Nothing in it waits
    for the device, except the gather of a sharded run. `shard` is (this
    rank's index, ranks, process group) over a "cells" mesh, or None."""
    dev = lane["arr"].device
    marks = []

    def mark(stage):
        if dev.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((stage, e))

    mark("start")
    lane_c, bh_c, cell0 = lane, bh, 0
    if shard is not None:
        index, n, group = shard
        per = lane["arr"].shape[0] // n
        cell0 = index * per
        lane_c = {k: v[cell0:cell0 + per] for k, v in lane.items()}
        bh_c = {k: v[cell0:cell0 + per] for k, v in bh.items()}
    edge_done, ctx, conf, on, ctx_bh, bh_done = _edge_tier(lane_c, bh_c, tbl, dims["D"], cell0)
    mark("edge")
    up_done, up_comm = _uplink(lane_c, tbl, edge_done, lane_c["valid"] & ~on, dims["B"],
                               dims["Rb"], cell0)
    mark("uplink")
    if shard is not None:
        edge_done, ctx, conf, on, ctx_bh, bh_done, up_done, up_comm = _gather_cells(
            [edge_done, ctx, conf, on, up_done, up_comm, ctx_bh, bh_done], index, n, group)
        mark("gather")
    offl = lane["valid"] & ~on
    s_a, cloud, s_b, cloud_bh = _cloud_tier(lane, bh, tbl, edge_done, offl, up_done, bh_done,
                                            dims["K"], dims["slowdowns"])
    mark("cloud")
    out = dict(edge_done=edge_done, ctx=ctx, conf=conf, on=on, up_done=up_done,
               up_comm=up_comm, s_eff=s_a, cloud=cloud, ctx_bh=ctx_bh, bh_done=bh_done,
               s_eff_bh=s_b, cloud_bh=cloud_bh)
    if dims["cal_bins"]:
        out["cal"] = _sketch(lane, tbl, ctx, conf, on, dims["n_ctx"], dims["cal_bins"])
        mark("sketch")
    return out, marks


class CompiledFleetSimulator(FleetSimulator):
    """Drop-in `FleetSimulator` whose `run` executes as one device program
    on the table's gate-backend device (the card under ``"compiled"``, the
    CPU under ``CompiledGateBackend(device="cpu")``).

    mesh: None runs the program on the backend's device alone; "auto"
    shards the cells over `sharding.fleet_mesh()` when the process group
    has more than one rank and they divide the cell count, else runs
    alone (`repro.fleet.compiled`'s rule); or a ``"cells"`` `MeshSpec`
    from `sharding.fleet_mesh`. A mesh that does not divide the cells,
    or any other object, raises ValueError. Every rank of a mesh must
    build and run the simulator; a rank outside the mesh runs alone.

    After `run`, `host_s` holds the host seconds of the pre-pass, the
    program (upload, program, one sync, download) and the recovery, and
    `stage_ms` the device ms of each program stage (edge, uplink, the
    gather over the mesh, cloud, sketch) from CUDA events on the card
    (empty elsewhere); over a mesh both are rank 0's on every rank.
    """

    def __init__(
        self,
        table: GateTable,
        topology: FleetTopology,
        profile: L.LatencyProfile,
        config: Optional[FleetConfig] = None,
        controller=None,
        payload_nbytes: Optional[Callable[[int], int]] = None,
        orchestrator=None,
        obs=None,
        mesh="auto",
    ):
        _check_scope(controller is not None, orchestrator)
        self.mesh = self._resolve_mesh(mesh, topology.n_cells)
        super().__init__(
            table, topology, profile, config=config, controller=None,
            payload_nbytes=payload_nbytes, orchestrator=orchestrator, obs=obs,
        )
        self.device = table.backend.device
        self.host_s: Dict[str, float] = {}
        self.stage_ms: Dict[str, float] = {}

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _resolve_mesh(mesh, n_cells: int) -> Optional[MeshSpec]:
        if mesh is None:
            return None
        if isinstance(mesh, str) and mesh == "auto":
            import torch.distributed as dist

            world = dist.get_world_size() if dist.is_initialized() else 1
            if world > 1 and n_cells % world == 0:
                from repro_torch.sharding import fleet_mesh

                return fleet_mesh()
            return None
        if not isinstance(mesh, MeshSpec) or mesh.axis_names != ("cells",):
            raise ValueError(
                "the compiled fleet pipeline takes mesh=None, 'auto' or a "
                f"'cells' mesh (sharding.fleet_mesh), not {mesh!r}"
            )
        if n_cells % mesh.size != 0:
            raise ValueError(
                f"{n_cells} cells do not shard evenly over a "
                f"{mesh.size}-device mesh"
            )
        if mesh.size > 1 and mesh.device_mesh is None:
            raise ValueError(
                f"a described {mesh.size}-device 'cells' mesh has no ranks: build it "
                "with sharding.fleet_mesh() under torch.distributed.run"
            )
        return mesh

    def _shard(self):
        """(this rank's index, ranks, group) over the mesh, or None when
        the run is not sharded."""
        m = self.mesh
        if m is None or m.size == 1 or m.coordinate("cells") is None:
            return None
        return m.coordinate("cells"), m.size, m.group("cells")

    def _min_rate(self, net) -> float:
        if isinstance(net, MarkovNetwork):
            return min(net.good_bps, net.bad_bps)
        if isinstance(net, TraceNetwork):
            return float(np.min(net.trace_rates_bps))
        if isinstance(net, FixedRateNetwork):
            return float(net.bps)
        raise ValueError(
            f"compiled fleet pipeline supports Fixed/Markov/Trace networks, "
            f"not {type(net).__name__}; use the host backend"
        )

    def _net_tables(self, t_bound: float):
        """Materialize every cell's link-rate lookup for the device.

        Slotted mode replicates `MarkovNetwork.rates_bps` exactly
        (floor-division into sequentially materialized dwell slots; a
        fixed link is a one-slot table); knot mode replicates
        `TraceNetwork.rates_bps` (searchsorted over knot times, modulo the
        replay period). Same lookup, same floats -- only the memory lives
        on the device for the run.
        """
        topo = self.topology
        C = topo.n_cells
        mode = np.zeros(C, np.int64)
        dwell = np.full(C, _BIG_DWELL)
        period = np.zeros(C)
        slot_rates: List[np.ndarray] = []
        knot_ts: List[np.ndarray] = []
        knot_rates: List[np.ndarray] = []
        for cell in topo.cells:
            net = cell.network
            if isinstance(net, MarkovNetwork):
                n_slots = int(max(t_bound, 0.0) // net.dwell_s) + 2
                rates = net.rates_bps((np.arange(n_slots) + 0.5) * net.dwell_s)
                dwell[len(slot_rates)] = net.dwell_s
                slot_rates.append(np.asarray(rates, np.float64))
                knot_ts.append(np.zeros(1))
                knot_rates.append(np.zeros(1))
            elif isinstance(net, TraceNetwork):
                mode[len(slot_rates)] = 1
                period[len(slot_rates)] = 0.0 if net.period_s is None else float(net.period_s)
                slot_rates.append(np.asarray([1.0]))
                knot_ts.append(np.asarray(net.times_s, np.float64))
                knot_rates.append(np.asarray(net.trace_rates_bps, np.float64))
            elif isinstance(net, FixedRateNetwork):
                slot_rates.append(np.asarray([net.bps], np.float64))
                knot_ts.append(np.zeros(1))
                knot_rates.append(np.zeros(1))
            else:  # pragma: no cover - guarded by _min_rate earlier
                raise ValueError(f"unsupported network {type(net).__name__}")
        S_net = max(len(r) for r in slot_rates)
        Kn = max(len(k) for k in knot_ts)
        slots = np.empty((C, S_net))
        kts = np.full((C, Kn), np.inf)
        krs = np.empty((C, Kn))
        for c in range(C):
            r = slot_rates[c]
            slots[c, : len(r)] = r
            slots[c, len(r):] = r[-1]
            kt, kr = knot_ts[c], knot_rates[c]
            kts[c, : len(kt)] = kt
            krs[c, : len(kr)] = kr
            krs[c, len(kr):] = kr[-1]
        return dict(
            net_mode=mode, net_dwell=dwell, net_period=period,
            net_slots=slots, net_knots=kts, net_rates=krs,
            net_any_knots=bool((mode == 1).any()),
        )

    def _ctx_tables(self, t_bound: float):
        """Materialize every cell's context-regime lookup for the device,
        already mapped through the schedule-context -> table-context ids
        (`_sched_map`), mirroring `FleetSimulator._ctx_ids` exactly."""
        topo = self.topology
        C = topo.n_cells
        mode = np.zeros(C, np.int64)
        dwell = np.full(C, _BIG_DWELL)
        slot_ids: List[np.ndarray] = []
        knot_ts: List[np.ndarray] = []
        knot_ids: List[np.ndarray] = []
        for c, cell in enumerate(topo.cells):
            sched = cell.schedule
            if sched is None:
                slot_ids.append(np.asarray([self._static_ctx[c]], np.int64))
                knot_ts.append(np.zeros(1))
                knot_ids.append(np.zeros(1, np.int64))
            elif isinstance(sched, MarkovContextSchedule):
                n_slots = int(max(t_bound, 0.0) // sched.dwell_s) + 2
                mids = (np.arange(n_slots) + 0.5) * sched.dwell_s
                ids = self._sched_map[c][sched.context_ids_at(mids)]
                dwell[c] = sched.dwell_s
                slot_ids.append(np.asarray(ids, np.int64))
                knot_ts.append(np.zeros(1))
                knot_ids.append(np.zeros(1, np.int64))
            elif isinstance(sched, PiecewiseSchedule):
                mode[c] = 1
                slot_ids.append(np.zeros(1, np.int64))
                knot_ts.append(np.asarray(sched.starts, np.float64))
                seg_ids = self._sched_map[c][sched.context_ids_at(sched.starts)]
                knot_ids.append(np.asarray(seg_ids, np.int64))
            else:
                raise ValueError(
                    f"compiled fleet pipeline supports Markov/Piecewise "
                    f"context schedules, not {type(sched).__name__}; use "
                    f"the host backend"
                )
        S_ctx = max(len(s) for s in slot_ids)
        Kc = max(len(k) for k in knot_ts)
        slots = np.empty((C, S_ctx), np.int64)
        kts = np.full((C, Kc), np.inf)
        kids = np.zeros((C, Kc), np.int64)
        for c in range(C):
            s = slot_ids[c]
            slots[c, : len(s)] = s
            slots[c, len(s):] = s[-1]
            kt, ki = knot_ts[c], knot_ids[c]
            kts[c, : len(kt)] = kt
            kids[c, : len(ki)] = ki
            kids[c, len(ki):] = ki[-1]
        return dict(
            ctx_mode=mode, ctx_dwell=dwell,
            ctx_slots=slots, ctx_knots=kts, ctx_kctx=kids,
            ctx_any_knots=bool((mode == 1).any()),
        )

    # ----------------------------------------------------------------- run
    def run(self) -> FleetTelemetry:
        t_start = time.perf_counter()
        topo, cfg, table = self.topology, self.config, self.table
        tel = FleetTelemetry(
            topo.n_cells,
            context_keys=table.ctx_keys,
            bank_keys=table.bank_keys or None,
        )
        for c, cell in enumerate(topo.cells):
            tel.set_arrivals(c, cell.workload.arrival_s)

        self._state = [self._initial_state for _ in topo.cells]
        self._active = topo.initial_active_mask()
        self._cell_tables = [None] * topo.n_cells
        self._backhaul_free = np.zeros(topo.n_cells)
        self.shed_counts = np.zeros(topo.n_cells, np.int64)
        orch = self.orchestrator
        self._live = _LiveCloud(topo.cloud_servers) if orch is not None else None

        ws = cfg.window_s
        C = topo.n_cells
        n_windows = int(math.ceil(max(topo.horizon_s, 0.0) / ws)) + 1
        branch, p_tar, clevel = self._initial_state
        s_edge = L.edge_time(self.profile, branch)
        s_cloud = L.cloud_time(self.profile, branch)
        # the static deployment fixes (branch, level), so the (branch,
        # level) -> bytes table collapses to one scalar; level 0 reuses the
        # raw tensor bytes unchanged (bit-exact legacy pricing)
        nbytes = float(self._payload_nbytes_for(branch, clevel))
        self._comm_bh = nbytes * 8.0 / self.profile.uplink_bps

        # ---- churn pre-pass: activation is pure time-based, so the
        # (window, origin) -> serving cell routing is known up front.
        active_w = np.empty((n_windows, C), bool)
        active = topo.initial_active_mask()
        churn = None if orch is None else orch.churn
        cursor = 0
        if churn is not None:
            from repro_torch.orchestration.churn import JOIN  # the package imports the fleet
        for w in range(n_windows):
            if churn is not None:
                due, cursor = churn.due(cursor, w * ws)
                for ev in due:
                    active[ev.cell] = ev.kind == JOIN
            active_w[w] = active

        # ---- batch layout in host (window, origin) order
        shed_orders: dict = {}
        batches: List[_Batch] = []
        by_window: List[List[_Batch]] = [[] for _ in range(n_windows)]
        ptr = np.zeros(C, np.int64)
        for w in range(n_windows):
            t1 = (w + 1) * ws
            act = active_w[w]
            for c, cell in enumerate(topo.cells):
                arr = cell.workload.arrival_s
                hi = int(np.searchsorted(arr, t1, side="left"))
                lo = int(ptr[c])
                ptr[c] = hi
                if hi == lo:
                    continue
                if act[c]:
                    serve, shed = c, False
                else:
                    shed = True
                    serve = -1
                    if c not in shed_orders:
                        shed_orders[c] = topo.shed_order(c)
                    for s in shed_orders[c]:
                        if act[s]:
                            serve = int(s)
                            break
                b = _Batch(w, c, serve, lo, hi, shed)
                batches.append(b)
                by_window[w].append(b)

        rowsA = np.zeros(C, np.int64)
        rowsB = np.zeros(C, np.int64)
        nbatchA = np.zeros(C, np.int64)
        max_batch = 1
        for b in batches:
            n = b.hi - b.lo
            max_batch = max(max_batch, n)
            if b.serve >= 0:
                b.row0 = int(rowsA[b.serve])
                b.blocal = int(nbatchA[b.serve])
                rowsA[b.serve] += n
                nbatchA[b.serve] += 1
            else:
                b.row0 = int(rowsB[b.origin])
                rowsB[b.origin] += n
        R = max(1, int(rowsA.max()))
        RB = max(1, int(rowsB.max()))
        B = max(1, int(nbatchA.max()))
        D = max(cell.n_devices for cell in topo.cells)

        lane = dict(
            arr=np.zeros((C, R)), smp=np.zeros((C, R), np.int64),
            dev=np.zeros((C, R), np.int64), org=np.zeros((C, R), np.int64),
            bl=np.zeros((C, R), np.int64), gid=np.zeros((C, R), np.int64),
            valid=np.zeros((C, R), bool),
        )
        bh = dict(
            arr=np.zeros((C, RB)), smp=np.zeros((C, RB), np.int64),
            gid=np.zeros((C, RB), np.int64), valid=np.zeros((C, RB), bool),
        )
        for b in batches:
            n = b.hi - b.lo
            wl = topo.cells[b.origin].workload
            gid = b.w * C + b.origin
            if b.serve >= 0:
                sl = (b.serve, slice(b.row0, b.row0 + n))
                lane["arr"][sl] = wl.arrival_s[b.lo:b.hi]
                lane["smp"][sl] = wl.sample[b.lo:b.hi]
                dev = wl.device[b.lo:b.hi]
                if b.shed:
                    dev = dev % topo.cells[b.serve].n_devices
                lane["dev"][sl] = dev
                lane["org"][sl] = b.origin
                lane["bl"][sl] = b.blocal
                lane["gid"][sl] = gid
                lane["valid"][sl] = True
            else:
                sl = (b.origin, slice(b.row0, b.row0 + n))
                bh["arr"][sl] = wl.arrival_s[b.lo:b.hi]
                bh["smp"][sl] = wl.sample[b.lo:b.hi]
                bh["gid"][sl] = gid
                bh["valid"][sl] = True

        # ---- materialized lookup tables (bounded by the worst completion
        # time any lookup can be queried at)
        t_edge_bound = topo.horizon_s + ws + (R + 1) * s_edge + 1.0
        max_comm = max(
            (nbytes * 8.0 / self._min_rate(cell.network) for cell in topo.cells),
            default=0.0,
        )
        t_net_bound = t_edge_bound + (R + 1) * max(max_comm, self._comm_bh) + 1.0
        bi = table.branch_idx(branch)
        host_tbl = dict(**self._net_tables(t_net_bound), **self._ctx_tables(t_edge_bound))
        cal_on = self._cal is not None and table.labels is not None
        if cal_on:
            # host float64 edges and per-(ctx, sample) EDGE correctness, so
            # the program's binning and correctness are the host sketch's
            host_tbl["cal_edges"] = bin_edges(self._cal.n_bins)
            host_tbl["ecorrect"] = (
                table.pred[:, bi, :] == table.labels[None, :]
            ).astype(np.float64)
        dims = dict(D=D, B=B, Rb=max_batch, K=topo.cloud_servers,
                    slowdowns=tuple(cfg.cloud_slowdowns), n_ctx=len(table.ctx_keys),
                    cal_bins=int(self._cal.n_bins) if cal_on else 0)
        t_prog = time.perf_counter()

        # ---- the device program: tables and lanes up once, one sync,
        # the columns back once
        dev = self.device

        def up(x):
            return x if isinstance(x, bool) else torch.as_tensor(x, device=dev)

        tbl = {k: up(v) for k, v in host_tbl.items()}
        # the float64 conf block stays where the gate backend keeps it
        tbl["conf"] = as_tensor(table._conf_t, dev)[:, bi].to(dev)
        tbl.update(s_edge=s_edge, s_cloud=s_cloud, nbytes8=nbytes * 8.0,
                   comm_bh=self._comm_bh, p_tar=p_tar)
        shard = self._shard()
        out_t, marks = _program({k: up(v) for k, v in lane.items()},
                                {k: up(v) for k, v in bh.items()}, tbl, dims, shard)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out = {k: v.cpu().numpy() for k, v in out_t.items()}
        self.stage_ms = {stage: a.elapsed_time(b)
                         for (_, a), (stage, b) in zip(marks, marks[1:])}
        t_rec = time.perf_counter()

        # ---- host recovery: per-request verdict columns (exact numpy
        # table math, same as the host simulator's gate aftermath)
        est = table.est_ids(out["ctx"].ravel(), lane["smp"].ravel())
        estA = np.full((C, R), -2, np.int64) if est is None else est.reshape(C, R)
        pred = table.pred[:, bi, :][out["ctx"], lane["smp"]]
        cpredA = table.cloud_pred(out["ctx"].ravel(), lane["smp"].ravel(),
                                  level=clevel).reshape(C, R)
        ce = table.correct(lane["smp"].ravel(), pred.ravel())
        cc = table.correct(lane["smp"].ravel(), cpredA.ravel())
        # EDGE-branch correctness, kept separately from the cloud-patched
        # column: the calibration stream audits the gate's own verdict
        self._ecA = None if ce is None else ce.reshape(C, R).astype(np.int8)
        if ce is None:
            correctA = np.full((C, R), -1, np.int8)
        else:
            correctA = np.where(out["on"], ce.reshape(C, R), cc.reshape(C, R)).astype(np.int8)
        completeA = np.where(out["on"], out["edge_done"], out["cloud"])
        cpredB = table.cloud_pred(out["ctx_bh"].ravel(), bh["smp"].ravel(),
                                  level=clevel).reshape(C, RB)
        ccB = table.correct(bh["smp"].ravel(), cpredB.ravel())
        correctB = (np.full((C, RB), -1, np.int8) if ccB is None
                    else ccB.reshape(C, RB).astype(np.int8))

        deadlines = [cell.deadline_s for cell in topo.cells]
        has_shed = any(b.shed for b in batches)
        obs_on = self.obs is not None and self.obs.enabled

        if orch is None and not obs_on and not has_shed:
            self._flush_fast(tel, lane, out, estA, correctA, completeA,
                             rowsA, deadlines, branch, p_tar, clevel, nbytes)
        else:
            self._replay(tel, lane, bh, out, estA, correctA, completeA,
                         correctB, by_window, n_windows, ws, deadlines,
                         branch, p_tar, clevel, nbytes, orch)
        if orch is not None:
            orch.finish(self, tel, n_windows * ws)
        t_end = time.perf_counter()
        self.host_s = {"prepass": t_prog - t_start, "program": t_rec - t_prog,
                       "recovery": t_end - t_rec}
        if shard is not None:
            self._rank0_times(shard)
        return tel

    def _rank0_times(self, shard) -> None:
        """Replace `host_s` and `stage_ms` by rank 0's on every rank."""
        index, _, group = shard
        keys = [("host_s", k) for k in self.host_s] + [("stage_ms", k) for k in self.stage_ms]
        vals = torch.tensor([getattr(self, a)[k] for a, k in keys], dtype=torch.float64,
                            device=self.device)
        vals = all_sum(vals if index == 0 else torch.zeros_like(vals), group).tolist()
        for (a, k), v in zip(keys, vals):
            getattr(self, a)[k] = v

    # ------------------------------------------------- host-side recovery
    def _est_mapped(self, est, ctx):
        return np.where(
            est >= 0, self._bank_to_table[np.maximum(est, 0)],
            np.where(est == -2, ctx, -1),
        )

    def _flush_fast(self, tel, lane, out, estA, correctA, completeA,
                    rowsA, deadlines, branch, p_tar, clevel, nbytes):
        """No churn, no orchestrator, no obs: flush whole per-cell columns.

        Chunking telemetry per cell instead of per (window, cell) batch is
        invisible to every reader (`_CellColumns` concatenates chunks and
        the observation streams are windowed by value), and the row order
        is the host's batch order, so the streams are element-identical.
        """
        C = self.topology.n_cells
        for c in range(C):
            n = int(rowsA[c])
            if n == 0:
                continue
            sl = (c, slice(0, n))
            arr = lane["arr"][sl]
            edge_done = out["edge_done"][sl]
            on = out["on"][sl]
            ctx = out["ctx"][sl]
            est = estA[sl]
            complete = completeA[sl]
            lat = complete - arr
            ded = deadlines[c]
            missed = (np.full(n, -1, np.int8) if ded is None
                      else (lat > ded).astype(np.int8))
            tel.observe_contexts(c, edge_done, self._est_mapped(est, ctx))
            off = ~on
            if off.any():
                order = np.lexsort((
                    np.arange(n)[off], edge_done[off], lane["bl"][sl][off],
                ))
                t_ready = edge_done[off][order]
                rates = nbytes * 8.0 / out["up_comm"][sl][off][order]
                tel.observe_bandwidth(c, t_ready, rates)
            tel.add_window(
                c, latency_s=lat, on_device=on, correct=correctA[sl],
                p_tar=np.full(n, p_tar), branch=np.full(n, branch, np.int64),
                ctx_id=ctx, est_id=est, missed=missed,
                energy_j=self._energy_col(
                    L.edge_time(self.profile, branch), on, branch, clevel
                ),
            )

    def _batch_cols(self, b, lane, bh, out, estA, correctA, completeA,
                    correctB, deadlines, branch, p_tar, clevel):
        n = b.hi - b.lo
        if b.serve >= 0:
            sl = (b.serve, slice(b.row0, b.row0 + n))
            cols = {
                "arrival": lane["arr"][sl],
                "samples": lane["smp"][sl],
                "edge_done": out["edge_done"][sl],
                "complete": completeA[sl],
                "on_device": out["on"][sl],
                "ctx_id": out["ctx"][sl],
                "est_id": estA[sl],
                "correct": correctA[sl],
                "branch": np.full(n, branch, np.int64),
                "p_tar": np.full(n, p_tar),
                "clevel": np.full(n, int(clevel), np.int64),
                "energy_j": self._energy_col(
                    L.edge_time(self.profile, branch), out["on"][sl],
                    branch, int(clevel),
                ),
                "deadline": deadlines[b.origin],
            }
            # cols["correct"] above is already cloud-patched; the live
            # calibration stream and gate trace records need the gate's
            # own verdict, so the edge column always rides along
            cols["edge_correct"] = (
                np.full(n, -1, np.int8) if self._ecA is None else self._ecA[sl]
            )
            if self._tracing:
                cols["conf"] = out["conf"][sl]
                cols["uplink_done"] = out["up_done"][sl]
                cols["uplink_start"] = out["up_done"][sl] - out["up_comm"][sl]
                cols["cloud_service"] = np.where(
                    cols["on_device"], np.nan, out["s_eff"][sl]
                )
                cols["serve_cell"] = b.serve
            elif self._live is not None:
                cols["conf"] = out["conf"][sl]
            return cols, out["up_comm"][sl], out["s_eff"][sl]
        sl = (b.origin, slice(b.row0, b.row0 + n))
        arr = bh["arr"][sl]
        cols = {
            "arrival": arr,
            "samples": bh["smp"][sl],
            "edge_done": arr.copy(),
            "complete": out["cloud_bh"][sl],
            "on_device": np.zeros(n, bool),
            "ctx_id": out["ctx_bh"][sl],
            "est_id": np.full(n, -2, np.int64),
            "correct": correctB[sl],
            "branch": np.full(n, branch, np.int64),
            "p_tar": np.full(n, p_tar),
            "clevel": np.full(n, int(clevel), np.int64),
            "energy_j": self._energy_col(0.0, np.zeros(n, bool), branch, int(clevel)),
            "deadline": deadlines[b.origin],
        }
        cols["edge_correct"] = np.full(n, -1, np.int8)
        comm = np.full(n, self._comm_bh)
        if self._tracing:
            cols["conf"] = np.full(n, np.nan)
            cols["uplink_done"] = out["bh_done"][sl]
            cols["uplink_start"] = out["bh_done"][sl] - comm
            cols["cloud_service"] = out["s_eff_bh"][sl]
            cols["serve_cell"] = -1
        elif self._live is not None:
            cols["conf"] = np.full(n, np.nan)
        return cols, comm, out["s_eff_bh"][sl]

    def _replay(self, tel, lane, bh, out, estA, correctA, completeA,
                correctB, by_window, n_windows, ws, deadlines, branch,
                p_tar, clevel, nbytes, orch):
        """Replay the host simulator's boundary bookkeeping from the
        device-solved columns, operation for operation in its order:
        live-cloud pops, orchestrator hooks (churn audit + QoS monitor),
        shed accounting, telemetry/metrics/audit per batch, then the
        shared flush + obs emission."""
        window_cols: List[Tuple[int, dict]] = []
        if orch is not None:
            orch.attach(self, tel, audit=self._audit)
        for w in range(n_windows):
            t0 = w * ws
            if orch is not None:
                if w > 0:
                    self._pop_live(t0, tel)
                orch.on_window(self, tel, w, t0)
            for b in by_window[w]:
                n = b.hi - b.lo
                cols, comm, s_eff = self._batch_cols(
                    b, lane, bh, out, estA, correctA, completeA, correctB,
                    deadlines, branch, p_tar, clevel,
                )
                if bool(self._active[b.origin]) == b.shed:
                    # pragma: no cover - internal consistency
                    raise RuntimeError(
                        "churn replay diverged from the precomputed "
                        "activation schedule"
                    )
                if b.shed:
                    self.shed_counts[b.origin] += n
                    if b.serve < 0 and self._cal is not None:
                        # backhauled without a gate decision: no
                        # calibration signal, but the sketch totals must
                        # still conserve fleet_requests_total
                        self._cal.note_ungated(b.origin, n)
                    if self._metrics is not None:
                        self._metrics.inc("fleet_shed_total", n, cell=b.origin)
                    arr = cols["arrival"]
                    if b.serve >= 0:
                        tel.observe_shed_arrivals(b.serve, arr)
                        if self._audit is not None:
                            self._audit.record(
                                float(arr[0]), "simulator", "shed_route",
                                cell=b.origin, host_cell=b.serve,
                                backhaul=False, requests=int(n))
                    elif self._audit is not None:
                        self._audit.record(
                            float(arr[0]), "simulator", "shed_route",
                            cell=b.origin, host_cell=None,
                            backhaul=True, requests=int(n))
                est = cols["est_id"]
                tel.observe_contexts(
                    b.serve if b.serve >= 0 else b.origin,
                    cols["edge_done"],
                    self._est_mapped(est, cols["ctx_id"]),
                )
                off = ~cols["on_device"]
                if self._metrics is not None:
                    self._metrics.inc("fleet_requests_total", n, cell=b.origin)
                    n_off = int(off.sum())
                    if n_off:
                        self._metrics.inc("fleet_offloaded_total", n_off, cell=b.origin)
                if off.any():
                    pos = np.flatnonzero(off)[
                        np.argsort(cols["edge_done"][off], kind="stable")
                    ]
                    t_ready = cols["edge_done"][pos]
                    if self._metrics is not None:
                        # uplink AND backhaul payloads count, attributed
                        # to the origin cell (host simulator's rule)
                        self._metrics.inc("fleet_uplink_bytes_total",
                                          nbytes * len(pos), cell=b.origin)
                    if b.serve >= 0:
                        tel.observe_bandwidth(b.serve, t_ready, nbytes * 8.0 / comm[pos])
                        done = out["up_done"][b.serve, b.row0:b.row0 + n][pos]
                    else:
                        done = out["bh_done"][b.origin, b.row0:b.row0 + n][pos]
                    if self._live is not None:
                        self._live.add(
                            done, s_eff[pos], b.origin,
                            cols["arrival"][pos], cols["deadline"],
                        )
                if self._live is not None:
                    self._observe_edge_live(b.origin, cols, tel)
                window_cols.append((b.origin, cols))
        if self._cal is not None and "cal" in out:
            self._ingest_cal(out["cal"], branch)
        self._flush(window_cols, tel)
        if self.obs is not None and self.obs.enabled:
            self._finish_obs(window_cols, tel)

    def _ingest_cal(self, cal: np.ndarray, branch: int) -> None:
        """Fold the device-binned `(7, C, n_ctx, n_bins+1)` reliability
        blocks into the sketch. Zero-count (cell, context) blocks are
        skipped so the sketch's key set matches the host simulator's
        (which only creates keys for contexts it actually served)."""
        keys = self.table.ctx_keys
        for c in range(cal.shape[1]):
            for k in range(cal.shape[2]):
                blk = cal[:, c, k, :]
                if blk[0].sum() <= 0:
                    continue
                self._cal.update_binned(c, keys[k], branch, blk)
