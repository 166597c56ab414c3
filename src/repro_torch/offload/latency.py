"""Latency models for the edge-cloud system (paper Sec. IV-E).

The paper's setup:
  * edge compute: per-layer AlexNet delays on an Intel i7 CPU, taken from
    Colburn et al. [16];
  * cloud compute: Google Colab K80 GPU;
  * uplink: 18.8 Mbps average Wi-Fi rate from Hu et al. [7];
  * communication delay = payload bytes / uplink rate.

Those constants ship as the `paper_2020` profile. Because no per-layer i7
table is printed in either paper, the edge numbers are derived from layer
FLOPs at the i7's measured effective throughput for AlexNet conv layers
(~12 GFLOP/s dense f32) -- the simulator consumes profiles as plain data,
so measured tables drop in unchanged.

Port of `repro.offload.latency` (pure Python). In place of the reference's
`tpu_v5e` tier profile, whose constants are a TPU's, `h100` builds the
profile from times the serving engine measured on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Dict, Mapping, Optional, Tuple

from repro_torch.kernels.compress import LEVELS as COMPRESSION_LEVELS
from repro_torch.kernels.compress import scaled_payload_nbytes
from repro_torch.models.convnet import LAYER_TABLE, payload_bytes

if TYPE_CHECKING:
    from repro_torch.offload.engine import EngineStats


@dataclass(frozen=True)
class LatencyProfile:
    name: str
    edge_layer_s: Dict[str, float]  # per-layer edge compute time (s/sample)
    cloud_layer_s: Dict[str, float]  # per-layer cloud compute time (s/sample)
    branch_s: Dict[str, float]  # per-branch head time on the edge
    uplink_bps: float
    # energy model (defaults so existing profile constructors are
    # untouched): radio energy per transmitted bit + edge compute power.
    # 50 nJ/bit is a Wi-Fi-class radio figure; 2 W a mobile SoC under a
    # conv workload. Energy per request = edge compute J + payload
    # bits * J/bit -- additive telemetry, never priced into latency.
    uplink_j_per_bit: float = 50e-9
    edge_power_w: float = 2.0


def _alexnet_layer_flops() -> Dict[str, float]:
    """Per-sample forward FLOPs for the 32x32 B-AlexNet of convnet.py."""
    flops = {}
    hw = {"conv1": 32, "conv2": 16, "conv3": 8, "conv4": 8, "conv5": 8}
    for name, kind, spec in LAYER_TABLE:
        if kind == "conv":
            s = hw[name]
            flops[name] = 2.0 * s * s * spec["k"] ** 2 * spec["cin"] * spec["cout"]
        else:
            flops[name] = 2.0 * spec["din"] * spec["dout"]
    return flops


# per-sample forward FLOPs of each side branch's head (conv + fc)
_BRANCH_FLOPS = {
    "branch1": 2.0 * 16 * 16 * 9 * 64 * 32 + 2.0 * 32 * 8 * 8 * 10,
    "branch2": 2.0 * 8 * 8 * 9 * 96 * 32 + 2.0 * 32 * 4 * 4 * 10,
}


def paper_2020() -> LatencyProfile:
    """The paper's constants: i7 edge, K80 cloud, 18.8 Mbps uplink."""
    flops = _alexnet_layer_flops()
    EDGE_GFLOPS = 12e9  # i7 effective on small convs [16]
    CLOUD_GFLOPS = 240e9  # K80 effective (fp32, small batches)
    edge = {k: v / EDGE_GFLOPS for k, v in flops.items()}
    cloud = {k: v / CLOUD_GFLOPS for k, v in flops.items()}
    branch = {k: v / EDGE_GFLOPS for k, v in _BRANCH_FLOPS.items()}
    return LatencyProfile(
        name="paper_2020",
        edge_layer_s=edge,
        cloud_layer_s=cloud,
        branch_s=branch,
        uplink_bps=18.8e6,  # [7]'s Wi-Fi scenario, as used in the paper
    )


def _split(measured: Mapping[int, float], parts_by_branch, flops) -> Dict[str, float]:
    """Per-part seconds whose sums over each branch's parts give back the
    measured seconds: branches are taken from the fewest parts up; each
    one's time, less what its parts already hold, is split over its new
    parts in proportion to their FLOPs."""
    out: Dict[str, float] = {}
    for b in sorted(measured, key=lambda b: len(parts_by_branch[b])):
        parts = parts_by_branch[b]
        new = [p for p in parts if p not in out]
        rest = measured[b] - sum(out[p] for p in parts if p in out)
        if not new or rest <= 0:
            raise ValueError(
                f"the measured {measured[b]:.6g} s of branch {b} leaves {rest:.6g} s for its "
                f"parts {new} beyond those of a shorter path: the times contradict the layer "
                f"nesting (measure both branches warm, at the same batch)")
        total = sum(flops[p] for p in new)
        out.update({p: rest * flops[p] / total for p in new})
    return out


def h100(stats: Mapping[int, "EngineStats"], uplink_bps: float, name: str = "h100"
         ) -> LatencyProfile:
    """A profile measured on the card: `stats` maps each branch (1 and 2)
    to the `offload.engine.EngineStats` of the convnet engine serving at
    that branch, whose per-sample edge seconds (``edge_time_s /
    requests``) and cloud seconds (``cloud_time_s / offloaded``) are split
    over the layers in proportion to `_alexnet_layer_flops()`, so that
    `edge_time` and `cloud_time` give back the measured values. A layer on
    no measured path of its tier (the cloud's conv1, the edge's conv3 to
    fc3) takes the tier's measured seconds per FLOP. `uplink_bps` is the
    link's rate; nothing of the card's own is assumed."""
    if set(stats) != {1, 2}:
        raise ValueError(f"h100 needs the stats of branches 1 and 2, got {sorted(stats)}")
    if any(s.requests == 0 or s.offloaded == 0 for s in stats.values()):
        raise ValueError("every branch's stats need served and offloaded samples")
    flops = dict(_alexnet_layer_flops(), **_BRANCH_FLOPS)
    edge = _split({b: s.edge_time_s / s.requests for b, s in stats.items()},
                  {b: EDGE_LAYERS_BY_BRANCH[b] + [f"branch{b}"] for b in stats}, flops)
    cloud = _split({b: s.cloud_time_s / s.offloaded for b, s in stats.items()},
                   CLOUD_LAYERS_BY_BRANCH, flops)
    tables = []
    for table in (edge, cloud):
        layers = {k: v for k, v in table.items() if not k.startswith("branch")}
        per_flop = sum(layers.values()) / sum(flops[k] for k in layers)
        tables.append({k: layers.get(k, flops[k] * per_flop) for k in _alexnet_layer_flops()})
    return LatencyProfile(
        name=name,
        edge_layer_s=tables[0],
        cloud_layer_s=tables[1],
        branch_s={k: v for k, v in edge.items() if k.startswith("branch")},
        uplink_bps=float(uplink_bps),
    )


# ------------------------------------------------------------- path timings
EDGE_LAYERS_BY_BRANCH = {1: ["conv1"], 2: ["conv1", "conv2"]}
CLOUD_LAYERS_BY_BRANCH = {
    1: ["conv2", "conv3", "conv4", "conv5", "fc1", "fc2", "fc3"],
    2: ["conv3", "conv4", "conv5", "fc1", "fc2", "fc3"],
}


def edge_time(profile: LatencyProfile, branch: int) -> float:
    """Per-sample time to reach + evaluate branch `branch` on the edge."""
    t = sum(profile.edge_layer_s[l] for l in EDGE_LAYERS_BY_BRANCH[branch])
    t += profile.branch_s[f"branch{branch}"]
    return t


def cloud_time(profile: LatencyProfile, from_branch: int) -> float:
    return sum(profile.cloud_layer_s[l] for l in CLOUD_LAYERS_BY_BRANCH[from_branch])


def payload_bytes_for(branch: int, level: int = 0) -> int:
    """THE (branch, level) -> wire bytes entry for the B-AlexNet payloads:
    the raw float32 activation at level 0 (bit-identical to the paper's
    pricing), the codec's analytic compressed size otherwise. Every
    latency/pricing surface reads payload sizes from here instead of
    recomputing tensor nbytes at call sites."""
    return scaled_payload_nbytes(payload_bytes(branch), level)


def payload_bytes_table(
    payload_nbytes: Optional[Callable[[int], int]] = None,
    branches: Tuple[int, ...] = (1, 2),
    levels: Tuple[int, ...] = COMPRESSION_LEVELS,
) -> Dict[Tuple[int, int], int]:
    """Dense (branch, level) -> wire bytes table. `payload_nbytes` maps a
    branch to its RAW float32 payload size (default: the B-AlexNet
    activations); compressed levels derive analytically from the codec's
    wire format, so pricing never touches a tensor."""
    raw = payload_nbytes or payload_bytes
    return {
        (b, l): scaled_payload_nbytes(raw(b), l)
        for b in branches for l in levels
    }


def energy_per_request_j(
    profile: LatencyProfile, edge_time_s: float, payload_nbytes: float = 0.0
) -> float:
    """Edge-side energy for one request: compute J + radio J for the
    shipped payload (0 bytes for an on-device answer)."""
    return (edge_time_s * profile.edge_power_w
            + payload_nbytes * 8.0 * profile.uplink_j_per_bit)


def comm_time(
    profile: LatencyProfile, from_branch: int, network=None, t: float = 0.0,
    level: int = 0,
) -> float:
    """Per-sample uplink time for branch `from_branch`'s activation at
    compression `level` (0 = the raw float32 payload, numerically the
    paper's constant).

    With `network` (any object with `comm_time(nbytes, t)`, such as the
    reference's `serving.network.NetworkModel`) the transfer is
    priced at the link's instantaneous rate at time `t`; the default is the
    profile's fixed uplink -- the paper's 18.8 Mbps constant, numerically
    unchanged.
    """
    nbytes = payload_bytes_for(from_branch, level)
    if network is None:
        return nbytes * 8.0 / profile.uplink_bps
    return network.comm_time(nbytes, t)
