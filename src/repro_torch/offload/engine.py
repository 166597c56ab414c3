"""Edge-cloud partitioned serving engine (port of `repro.offload.engine`).

A small serving runtime around the two partitions of a model:

    edge partition  = blocks [0..exit_k] + exit head   (the device)
    cloud partition = blocks [exit_k..L] + main head   (the pod)

Per request batch: the edge partition runs first; the calibrated gate of
the deployed OffloadPlan (on the card, the fused K1 kernel) marks which
samples exit on-device; only the refused samples' activations -- picked
out with an index-select on the device -- go to the cloud partition,
through the K3/K4 codec when the plan's `compression_level` is not 0.
The engine gates with the CalibratorState of the branch that is
PHYSICALLY deployed on the edge, and keeps running statistics. It works
for the convnet (per-image classification, the paper's case) and for the
LM families (per-sequence classification at prefill: the edge runs the
blocks up to an exit, and the refused rows' (m, s, d) hidden goes to the
cloud partition).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch._device import as_tensor, require_device, resolve_device, to_numpy
from repro_torch.core.policy import OffloadPlan
from repro_torch.kernels import compress
from repro_torch.models import convnet, transformer
from repro_torch.sharding import mesh_device, mesh_scope, rows_of


@dataclass
class EngineStats:
    requests: int = 0
    on_device: int = 0
    offloaded: int = 0
    payload_bytes: int = 0
    edge_calls: int = 0
    cloud_calls: int = 0
    edge_time_s: float = 0.0  # wall-clock in edge_fn (blocked on device)
    cloud_time_s: float = 0.0  # wall-clock in cloud_fn

    @property
    def offload_rate(self):
        return self.offloaded / max(self.requests, 1)


def _block_until_ready(tree):
    """Wait for the card when any tensor of `tree` lives on it."""
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in pytree.tree_leaves(tree)):
        torch.cuda.synchronize()
    return tree


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in pytree.tree_leaves(tree))


class OffloadEngine:
    """Generic two-tier engine over (edge_fn, cloud_fn) callables.

    edge_fn(batch)  -> {"exit_logits": (b, C) tensor, "payload": tensor tree}
    cloud_fn(payload_subset) -> {"logits": (m, C) tensor}

    `branch` is the index (into plan.calibrators) of the exit the edge
    partition actually computes; defaults to plan.exit_index. `use_kernel`
    is kept for parity with `repro`: on the card the gate always runs K1.
    `edge_step` and `cloud_step` block until the device is done and
    accumulate wall-clock in EngineStats; `timing_hook(tier, seconds,
    batch_size)` observes every call (tier is "edge" or "cloud").
    """

    def __init__(
        self,
        edge_fn: Callable,
        cloud_fn: Callable,
        plan: OffloadPlan,
        payload_nbytes: Optional[Callable[[Any], int]] = None,
        branch: Optional[int] = None,
        use_kernel: bool = False,
        timing_hook: Optional[Callable[[str, float, int], None]] = None,
    ):
        self.edge_fn = edge_fn
        self.cloud_fn = cloud_fn
        self.plan = plan
        self.branch = plan.exit_index if branch is None else branch
        if not 0 <= self.branch < plan.num_exits:
            raise ValueError(
                f"deployed branch index {self.branch} has no calibrator state "
                f"(plan covers {plan.num_exits} exit(s))"
            )
        self.use_kernel = use_kernel
        self.payload_nbytes = payload_nbytes or _nbytes
        self.timing_hook = timing_hook
        self.stats = EngineStats()

    @property
    def policy(self) -> OffloadPlan:  # legacy name
        return self.plan

    # ------------------------------------------------------- timed steps
    def edge_step(self, batch) -> Dict[str, Any]:
        """Run the edge partition on one request batch (timed, blocking)."""
        t0 = time.perf_counter()
        out = _block_until_ready(self.edge_fn(batch))
        dt = time.perf_counter() - t0
        b = int(out["exit_logits"].shape[0])
        self.stats.edge_calls += 1
        self.stats.edge_time_s += dt
        if self.timing_hook is not None:
            self.timing_hook("edge", dt, b)
        return out

    def cloud_step(self, payload) -> Dict[str, Any]:
        """Run the cloud partition on a refused-sample payload (timed)."""
        t0 = time.perf_counter()
        out = _block_until_ready(self.cloud_fn(payload))
        dt = time.perf_counter() - t0
        m = int(out["logits"].shape[0])
        self.stats.cloud_calls += 1
        self.stats.cloud_time_s += dt
        if self.timing_hook is not None:
            self.timing_hook("cloud", dt, m)
        return out

    def infer(self, batch) -> Dict[str, np.ndarray]:
        edge_out = self.edge_step(batch)
        gate = self.plan.gate(edge_out["exit_logits"], branch=self.branch,
                              use_kernel=self.use_kernel)
        mask = gate.exit_mask
        pred = gate.prediction.clone()
        conf = gate.confidence.clone()
        refused = torch.nonzero(~mask).reshape(-1)  # stays on the device
        n_refused = int(refused.numel())

        self.stats.requests += int(mask.shape[0])
        self.stats.on_device += int(mask.shape[0]) - n_refused

        if n_refused:
            payload = pytree.tree_map(lambda x: x.index_select(0, refused), edge_out["payload"])
            self.stats.offloaded += n_refused
            level = int(getattr(self.plan, "compression_level", 0))
            if level != 0:
                # the plan priced this deployment at the codec's wire bytes;
                # ship the ACTUAL encoded payload (K3 on the card) and charge
                # its analytic size
                leaves, spec = pytree.tree_flatten(payload)
                encs = [compress.encode(x, level) for x in leaves]
                self.stats.payload_bytes += sum(e.nbytes for e in encs)
                payload = pytree.tree_unflatten([compress.decode(e) for e in encs], spec)
            else:
                self.stats.payload_bytes += self.payload_nbytes(payload)
            cloud_out = self.cloud_step(payload)
            cloud_logits = as_tensor(cloud_out["logits"], pred.device).to(pred.device,
                                                                          torch.float32)
            z = cloud_logits - torch.amax(cloud_logits, dim=-1, keepdim=True)
            p = torch.exp(z) / torch.sum(torch.exp(z), dim=-1, keepdim=True)
            pred[refused] = torch.argmax(cloud_logits, dim=-1).to(pred.dtype)
            conf[refused] = torch.amax(p, dim=-1)
        return {
            "prediction": to_numpy(pred),
            "confidence": to_numpy(conf),
            "on_device": to_numpy(mask),
        }


# ------------------------------------------------------- concrete bindings
def convnet_engine(params, plan: OffloadPlan, branch: int = 1,
                   use_kernel: bool = False, device=None) -> OffloadEngine:
    """The paper's system: B-AlexNet split at side branch `branch`.

    Physical branch k (1-based) gates with plan.calibrators[k-1]. Runs on
    `device` (``cuda`` unless the caller passes ``"cpu"``): the params
    and each batch's ``"images"`` (NHWC) are moved there.
    """
    device = resolve_device(device)
    params = pytree.tree_map(lambda x: x.to(device), params)

    def edge(batch):
        images = as_tensor(batch["images"], device).to(device=device, dtype=torch.float32)
        with torch.no_grad():
            logits, hidden = convnet.edge_forward(params, images, branch=branch)
        return {"exit_logits": logits, "payload": hidden}

    def cloud(hidden):
        with torch.no_grad():
            return {"logits": convnet.cloud_forward(params, hidden, from_branch=branch)}

    return OffloadEngine(edge, cloud, plan, branch=branch - 1, use_kernel=use_kernel)


def lm_engine(params, cfg, plan: OffloadPlan, exit_index: int = 0,
              device=None, mesh=None) -> OffloadEngine:
    """LM variant: classify-at-prefill; edge = blocks up to the exit.

    Runs on `device` (``cuda`` unless the caller passes ``"cpu"``): the
    params must live there (else ValueError), and each batch's
    ``"tokens"`` (b, s) is moved there. At a non-zero codec level the
    cloud partition receives the payload decoded to float32 and runs in
    float32 (the reference's promotion).

    Over a (data, model) `mesh` of ranks (params from `init_params(mesh=)`),
    every rank calls `infer` on the same batch: each partition runs on the
    rank's rows (where the data axis divides them) under the mesh, as the
    serve steps do, and its outputs are gathered over the data axis, so
    the gate, the payload, the codec (K1, K3, K4) and the statistics are
    one device's on every rank: `payload_bytes` counts the payload once.
    """
    device = mesh_device(mesh, device)
    require_device(params["embed"]["w"].device, device, "the params")

    def edge(batch):
        tokens = as_tensor(batch["tokens"], device).to(device)
        local, sharded, gather = rows_of({"tokens": tokens}, mesh)
        with torch.no_grad(), mesh_scope(mesh, sharded):
            out = transformer.edge_forward(params, cfg, local, exit_index=exit_index)
            return {"exit_logits": gather(out["exit_logits"][:, 0, :]),
                    "payload": gather(out["hidden"])}

    def cloud(hidden):
        local, sharded, gather = rows_of({"hidden": hidden}, mesh)
        with torch.no_grad(), mesh_scope(mesh, sharded):
            out = transformer.cloud_forward(params, cfg, local["hidden"], exit_index=exit_index)
            return {"logits": gather(out["logits"][:, 0, :])}

    return OffloadEngine(edge, cloud, plan, branch=exit_index)
