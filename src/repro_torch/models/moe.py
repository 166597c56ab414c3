"""Mixture-of-Experts block: top-k routing with capacity-bounded scatter
dispatch (port of `repro.models.moe`).

* The router runs in float32: softmax over the experts, top-k, and the
  kept gates renormalised to sum to 1 per token.
* Each (token, slot) takes the next free position of its expert, in token
  order: a cumsum over the one-hot (E, T*k) assignment. Positions at or
  past the capacity C = int(T*k*cf/E) + 1 (kept within [8, T]) are
  dropped: their gate is 0 and the token flows through the residual, as
  in Switch/GShard.
* Dispatch scatters the kept rows into a zeroed (E, C, d) buffer with
  ``index_put(..., accumulate=True)``. A dropped row is zeroed and lands
  in slot C-1, so every slot receives at most one real row plus zeros and
  the sum is exact in any order.
* The experts are batched products over (E, C, d); combine gathers each
  (token, slot)'s output and weights it by the kept gate.
* With ``moe_shard_capacity`` the experts are padded to a multiple of 16;
  the padded experts get -1e30 router logits (probability 0) and never
  win.

Under a model axis (`sharding.use_mesh`, ``w_*`` cut to this rank's
block of E/M experts by the rule ``moe/w_*`` -> ("tp", None, None)) the
router stays replicated, so every model rank routes every token as one
device does: the capacity, positions, drops and aux loss are one
device's. Each rank's buffer holds only its experts, (E/M, C, d); a
(token, slot) of another rank's expert adds zero, and the ranks' float32
sums of their slots' contributions are added by one all-reduce over the
model axis and rounded once (as `layers.reduce_partial`). Padded experts
live on the last ranks only and never receive a row. Experts that the
axis does not divide stay whole on every rank, which runs them all as
one device. Under autograd the tokens entering the buffer and the kept
gates weighting this rank's slots go through `layers.enter_split`: each
rank's gradient of them covers its experts' slots only, and the sum
over the axis is one device's (so the replicated router learns from the
whole combine).

Under `data_parallel` (W ranks, each with an equal shard of the tokens,
in rank order: the train step's data mesh) the block keeps the one-device
semantics on the global batch, as GSPMD keeps the reference's under a
data mesh: C is the global token count's; a (token, slot)'s position in
its expert is its rank in the global token order, the local cumsum
offset by the lower ranks' per-expert counts, and it drops iff that
position reaches C; ``frac_tokens``, ``frac_probs`` and the dropped share
are global. One all-reduce per layer carries the counts and the
probability sums. A rank's expert buffer holds only its own kept rows:
(E, c_loc, d), c_loc the most rows any expert keeps on this rank, read
on the host once per layer (a device sync), so the expert FFN's work a
rank is about 1/W of one device's rather than one device's capacity C.
The aux loss's gradient reaches a rank's router through its own tokens,
scaled by W, so that the train step's mean of the ranks' gradients is
the one-device gradient.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.launch.mesh import gather_blocks
from repro_torch.models.layers import (
    cdtype,
    einsum,
    enter_split,
    normal,
    reduce_partial,
    split_width,
)

# (process group, this rank's index, ranks) while `data_parallel` is open;
# module state, not a context variable: a checkpointed layer recomputes
# its forward on autograd's own thread
_DP = None


@contextlib.contextmanager
def data_parallel(group, rank: int, world: int):
    """Run the MoE blocks as one block over the tokens of `world` ranks
    (this rank's are block `rank`); one rank is the plain block."""
    global _DP
    prev, _DP = _DP, ((group, rank, world) if world > 1 else None)
    try:
        yield
    finally:
        _DP = prev


def n_alloc_experts(cfg) -> int:
    """Allocated expert count: padded to a multiple of 16 under the
    shard-friendly variant (granite's 40 experts -> 48)."""
    E = cfg.moe_num_experts
    if cfg.moe_shard_capacity:
        return ((E + 15) // 16) * 16
    return E


def init_moe(generator, cfg):
    d, E, f = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
    Ea = n_alloc_experts(cfg)
    dt = cdtype(cfg)
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {
        "router": normal(generator, (d, E), s_in, torch.float32),
        "w_up": normal(generator, (Ea, d, f), s_in, dt),
        "w_down": normal(generator, (Ea, f, d), s_out, dt),
    }
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = normal(generator, (Ea, d, f), s_in, dt)
    return p


def moe_capacity(cfg, n_tokens: int) -> int:
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    c = int(n_tokens * k * cfg.moe_capacity_factor / E) + 1
    # never below 8, never above what top-k could ever fill
    return min(max(c, 8), n_tokens)


def apply_moe(p, cfg, x):
    """x: (..., d). Returns (y, aux) where aux holds the Switch
    load-balance loss and the dropped share of (token, slot) pairs."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xt = x.reshape(-1, d)  # (T, d)
    T = xt.shape[0]
    E, k = n_alloc_experts(cfg), cfg.moe_top_k
    E_loc = p["w_up"].shape[0]
    tp = split_width(E_loc, E)
    e0 = 0 if tp is None else tp[1] * E_loc  # this rank's first expert
    dp = _DP
    w = 1 if dp is None else dp[2]
    C = moe_capacity(cfg, T * w)

    # ---- router (fp32) ----
    logits = xt.to(torch.float32) @ p["router"]  # (T, E_real)
    if E > cfg.moe_num_experts:  # padded experts can never win top-k
        pad = logits.new_full((T, E - cfg.moe_num_experts), -1e30)
        logits = torch.cat([logits, pad], dim=-1)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)  # (T, k), descending
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # ---- capacity assignment: position of each (token, slot) in its expert
    eidx = expert_idx.reshape(T * k)
    experts = torch.arange(E, device=x.device)
    # the one-hot (E, T*k) by comparison (F.one_hot checks its indices on
    # the host, a device sync per call), scanned along its inner dim: the
    # outer-dim scan of a (T*k, E) one-hot is a slow CUDA kernel
    flat = (experts[:, None] == eidx).to(torch.int32)  # (E, T*k)
    pos = (torch.cumsum(flat, dim=1) - flat).gather(0, eidx[None, :])[0]
    top1 = (expert_idx[:, :1] == experts).to(torch.float32)  # (T, E)
    if dp is None:
        keep = pos < C
    else:
        group, rank, _ = dp
        # per rank: slots per expert, top-1 tokens per expert, router
        # probability sums (float32 sums, exact in float64)
        stats = torch.cat([flat.sum(1).to(torch.float64), top1.sum(0).to(torch.float64),
                           probs.detach().sum(0).to(torch.float64)])
        blocks = gather_blocks(stats, rank, w, group)  # (w, 3E)
        counts = blocks[:, :E]
        below = counts[:rank].sum(0)
        keep = pos + below.to(pos.dtype)[eidx] < C
        # this rank keeps an expert's first min(count, C - below) slots
        kept_here = torch.minimum(counts[rank], torch.clamp(C - below, min=0))
        # a fake tensor (the dry run's trace) has no values: size at the bound C
        c_loc = (C if isinstance(kept_here, FakeTensor)
                 else max(1, int(kept_here[e0:e0 + E_loc].max())))
    gates = enter_split(gate_vals.reshape(T * k) * keep.to(torch.float32), tp)

    # ---- dispatch: scatter tokens into (E_loc, C_loc, d) buffers (C_loc =
    # C on one device; a kept slot's local position is below C_loc; E_loc
    # = E unless the experts are split over the model axis)
    if dp is None:
        c_loc = C
    mine = keep if tp is None else keep & (eidx >= e0) & (eidx < e0 + E_loc)
    safe_pos = torch.where(mine, pos, c_loc - 1).to(torch.int64)
    safe_e = eidx if tp is None else torch.where(mine, eidx - e0, 0)
    src = torch.repeat_interleave(enter_split(xt, tp), k, dim=0) * mine[:, None].to(xt.dtype)
    buf = xt.new_zeros((E_loc, c_loc, d)).index_put((safe_e, safe_pos), src, accumulate=True)

    # ---- expert FFN: (E, C, d) x (E, d, f) ----
    up = einsum("ecd,edf->ecf", buf, p["w_up"])
    if cfg.mlp_type == "swiglu":
        up = F.silu(einsum("ecd,edf->ecf", buf, p["w_gate"])) * up
    else:
        up = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default
    out_buf = einsum("ecf,efd->ecd", up, p["w_down"])  # (E, C, d)

    # ---- combine: gather each (token, slot)'s expert output ----
    gathered = out_buf[safe_e, safe_pos]  # (T*k, d)
    if tp is None:
        y = torch.sum((gathered * gates[:, None].to(gathered.dtype)).reshape(T, k, -1), dim=1)
    else:  # this rank's slots, float32 sums reduced over the model axis
        part = gathered * (gates * mine.to(torch.float32))[:, None].to(gathered.dtype)
        y = reduce_partial(torch.sum(part.reshape(T, k, -1).to(torch.float32), dim=1), tp,
                           gathered.dtype)

    # ---- Switch load-balance aux loss ----
    if dp is None:
        frac_tokens = torch.mean(top1, dim=0)
        frac_probs = torch.mean(probs, dim=0)
        dropped = 1.0 - torch.mean(keep.to(torch.float32))
    else:
        n_all = T * w
        frac_tokens = blocks[:, E:2 * E].sum(0).to(torch.float32) / n_all
        p_loc = torch.sum(probs, dim=0)
        # the global sum's value, this rank's tokens' gradient times w
        frac_probs = (blocks[:, 2 * E:].sum(0).to(torch.float32)
                      + w * (p_loc - p_loc.detach())) / n_all
        kept = torch.clamp(counts.sum(0), max=C).sum()
        dropped = 1.0 - kept.to(torch.float32) / (n_all * k)
    aux = {
        "moe_aux_loss": E * torch.sum(frac_tokens * frac_probs),
        "moe_dropped_frac": dropped,
    }
    return y.reshape(orig_shape), aux
