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
  win. The reference's sharding constraints have no counterpart on one
  card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import cdtype, einsum, normal


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
    C = moe_capacity(cfg, T)

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
    keep = pos < C
    gates = gate_vals.reshape(T * k) * keep.to(torch.float32)

    # ---- dispatch: scatter tokens into (E, C, d) buffers ----
    safe_pos = torch.where(keep, pos, C - 1).to(torch.int64)
    src = torch.repeat_interleave(xt, k, dim=0) * keep[:, None].to(xt.dtype)
    buf = xt.new_zeros((E, C, d)).index_put((eidx, safe_pos), src, accumulate=True)

    # ---- expert FFN: (E, C, d) x (E, d, f) ----
    up = einsum("ecd,edf->ecf", buf, p["w_up"])
    if cfg.mlp_type == "swiglu":
        up = F.silu(einsum("ecd,edf->ecf", buf, p["w_gate"])) * up
    else:
        up = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default
    out_buf = einsum("ecf,efd->ecd", up, p["w_down"])  # (E, C, d)

    # ---- combine: gather each (token, slot)'s expert output ----
    gathered = out_buf[eidx, safe_pos]  # (T*k, d)
    y = torch.sum((gathered * gates[:, None].to(gathered.dtype)).reshape(T, k, -1), dim=1)

    # ---- Switch load-balance aux loss ----
    frac_tokens = torch.mean((expert_idx[:, :1] == experts).to(torch.float32), dim=0)
    frac_probs = torch.mean(probs, dim=0)
    aux = {
        "moe_aux_loss": E * torch.sum(frac_tokens * frac_probs),
        "moe_dropped_frac": 1.0 - torch.mean(keep.to(torch.float32)),
    }
    return y.reshape(orig_shape), aux
