"""GQA attention: chunked causal prefill + KV-cache decode (port of
`repro.models.attention`).

Features driven by ModelConfig: grouped-query attention (num_kv_heads <
num_heads), qk-norm (Qwen3), QKV bias (Qwen2), sliding-window masking,
RoPE or no-PE, and cross-attention to a `memory` sequence.

Attention is plain torch ops that mirror the reference's casts (the
reference's attention is XLA, not a Pallas kernel): scores are the
einsum of q and k in their own dtype, cast to float32 after the product
and scaled; masked scores are ``NEG_INF``; the softmax runs in float32
and the probabilities are cast back to v's dtype before the PV product.
qk-norm and RoPE are the exception at inference: with autograd off and q,
k on the card in a dtype and head_dim K5 takes, they are K5's one launch
(`kernels.qk_rope`, the same arithmetic; 44 launches and a host sync
fewer in a Qwen3 layer). Under autograd (the train step), on the CPU,
without RoPE (jamba, whisper) and at other head_dims or dtypes they run
as the plain chain of `layers.rms_norm_headwise`, `rope_freqs` and
`apply_rope`.

Prefill walks the query chunks in a Python loop with an O(chunk x seq)
working set. Decode writes the new token's K/V into the cache IN PLACE
and returns the same dict: a cache passed to a decode step must not be
used again as the state before that step. With a sliding window the
cache is a ring buffer of min(seq_len, window) slots; without one,
decoding past the cache's length raises `ValueError` (the reference's
`dynamic_update_slice` would clamp the slot and overwrite the last one).

Under a model axis (`sharding.use_mesh`) each rank holds its block of
the q heads and, where the axis divides them, of the kv heads (their
biases cut the same way, its cache holding only those): it projects and
attends over its own heads, and ``wo`` is row-parallel
(`layers.row_parallel`'s reduction). Global q head h reads kv head
h // (qh / kvh); where the kv heads are whole (8 kv heads over 16
ranks) the rank projects and caches all of them and attends with the
ones its q heads read (`_rank_kv`).

Under autograd (the tensor-parallel train step) the input of a split
projection goes through `layers.enter_split`, as do ``q_norm`` and
``k_norm`` where they scale this rank's heads only; where the kv heads
are whole, k and v go through it after their projection instead, since
each rank's attention reads only the kv heads its q heads use. An
attention to a memory (cross-attention, the encoder's bidirectional
self-attention) splits the same way, its memory entering the kv heads'
split as x does, a cross-attention's where its caller puts it
(`attention_prefill`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import qk_rope
from repro_torch.models.layers import (
    apply_rope,
    cdtype,
    einsum,
    enter_split,
    normal,
    partial_product,
    promote,
    reduce_partial,
    rms_norm_headwise,
    rope_freqs,
    split_width,
)

NEG_INF = -1e30


def init_attention(generator, cfg):
    d, hd, qh, kvh = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    dt = cdtype(cfg)
    dev = generator.device
    s = d ** -0.5
    so = (qh * hd) ** -0.5
    p = {
        "wq": normal(generator, (d, qh, hd), s, dt),
        "wk": normal(generator, (d, kvh, hd), s, dt),
        "wv": normal(generator, (d, kvh, hd), s, dt),
        "wo": normal(generator, (qh, hd, d), so, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((qh, hd), dtype=dt, device=dev)
        p["bk"] = torch.zeros((kvh, hd), dtype=dt, device=dev)
        p["bv"] = torch.zeros((kvh, hd), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, device=dev)
        p["k_norm"] = torch.ones(hd, device=dev)
    return p


def _add(x, b):
    """x + b with JAX's dtype promotion."""
    x, b = promote(x, b)
    return x + b


def _project_qkv(p, cfg, x, positions, rope=True):
    """x: (b, s, d) -> q (b,s,qh,hd), k/v (b,s,kvh,hd). With RoPE on,
    without autograd and on tensors K5 takes (`qk_rope.takes`: the card, a
    dtype and head_dim it reads), qk-norm and RoPE are K5's one launch;
    otherwise the plain chain."""
    qs = split_width(p["wq"].shape[-2], cfg.num_heads)
    kvs = split_width(p["wk"].shape[-2], cfg.num_kv_heads)
    xq = enter_split(x, qs)
    xkv = xq if kvs is not None else x  # whole kv heads: k, v enter in `_rank_kv`
    q = einsum("bsd,dhk->bshk", xq, p["wq"])
    k = einsum("bsd,dhk->bshk", xkv, p["wk"])
    v = einsum("bsd,dhk->bshk", xkv, p["wv"])
    if cfg.qkv_bias:
        q, k, v = _add(q, p["bq"]), _add(k, p["bk"]), _add(v, p["bv"])
    rope = rope and cfg.use_rope
    if rope and not torch.is_grad_enabled() and qk_rope.takes(q, k, positions):
        scales = (p["q_norm"], p["k_norm"]) if cfg.qk_norm else (None, None)
        q, k = qk_rope.qk_norm_rope(q, k, *scales, positions, cfg.rope_theta)
        return q, k, v
    if cfg.qk_norm:
        q = rms_norm_headwise(q, enter_split(p["q_norm"], qs))
        k = rms_norm_headwise(k, enter_split(p["k_norm"], kvs))
    if rope:
        cos, sin = rope_freqs(cfg, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _rank_kv(cfg, q, k, v):
    """The kv heads this rank's q heads read, grouped as `_gqa_scores`
    groups them: k/v as they are unless the q heads are split over the
    model axis and the kv heads are whole. Then local q head j (global
    h = index * qh_loc + j) reads kv head h // g: a contiguous run of kv
    heads when each serves the same count of local q heads, else one kv
    head per q head."""
    qh_loc, kvh = q.shape[2], cfg.num_kv_heads
    split = split_width(qh_loc, cfg.num_heads)
    if split is None or k.shape[2] != kvh:
        return k, v
    k, v = enter_split(k, split), enter_split(v, split)
    g = cfg.num_heads // kvh
    heads = [(split[1] * qh_loc + j) // g for j in range(qh_loc)]
    lo, n = heads[0], heads[-1] - heads[0] + 1
    if qh_loc % n == 0 and heads == [lo + j // (qh_loc // n) for j in range(qh_loc)]:
        return k.narrow(2, lo, n), v.narrow(2, lo, n)
    idx = torch.tensor(heads, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _out_proj(p, cfg, o):
    """o (b, s, qh, hd) through ``wo`` -> (b, s, d); row-parallel over the
    model axis when ``wo``'s heads are split."""
    wo = p["wo"]
    split = split_width(wo.shape[0], cfg.num_heads)
    if split is None:
        return einsum("bshk,hkd->bsd", o, wo)
    y = partial_product(o.reshape(o.shape[:2] + (-1,)), wo.reshape(-1, wo.shape[-1]))
    return reduce_partial(y, split, torch.promote_types(o.dtype, wo.dtype))


def _gqa_scores(q, k):
    """q: (b,sq,qh,hd) k: (b,sk,kvh,hd) -> (b,kvh,g,sq,sk) fp32."""
    b, sq, qh, hd = q.shape
    kvh = k.shape[2]
    g = qh // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    s = einsum("bqhgk,bshk->bhgqs", qg, k).to(torch.float32)
    return s * (hd ** -0.5)


def _gqa_out(probs, v):
    """probs: (b,kvh,g,sq,sk) fp32; v: (b,sk,kvh,hd) -> (b,sq,qh,hd)."""
    b, kvh, g, sq, sk = probs.shape
    hd = v.shape[-1]
    o = torch.einsum("bhgqs,bshk->bqhgk", probs.to(v.dtype), v)
    return o.reshape(b, sq, kvh * g, hd)


def _softmax_out(scores, v):
    return _gqa_out(torch.softmax(scores, dim=-1), v)


def _memory_q(p, cfg, xq):
    """The queries of an attention to a memory, from `xq` (x as it enters
    the q heads' split): no rope and no qk-norm, as the reference's."""
    q = einsum("bsd,dhk->bshk", xq, p["wq"])
    return _add(q, p["bq"]) if cfg.qkv_bias else q


def attention_prefill(p, cfg, x, positions, q_chunk=1024, memory=None):
    """Causal (optionally sliding-window) self-attention over a full sequence.

    x: (b, s, d); positions: (b, s) int. Returns (out (b,s,d), cache).
    ``memory``: if given (cross-attention), attend to it instead (no mask).
    Under a model axis ``memory is x`` (the encoder's bidirectional
    self-attention) enters the split once for q, k and v; any other
    memory is projected as it comes: its caller enters it into the kv
    heads' split, once for every layer that reads it
    (`whisper._enter_memory`).
    """
    b, s, d = x.shape
    if memory is not None:
        xq = enter_split(x, split_width(p["wq"].shape[-2], cfg.num_heads))
        if memory is x and split_width(p["wk"].shape[-2], cfg.num_kv_heads) is not None:
            memory = xq  # whole kv heads: k and v enter in `_rank_kv` instead
        q = _memory_q(p, cfg, xq)
        k = einsum("bsd,dhk->bshk", memory, p["wk"])
        v = einsum("bsd,dhk->bshk", memory, p["wv"])
        ka, va = _rank_kv(cfg, q, k, v)
        o = _softmax_out(_gqa_scores(q, ka), va)
        return _out_proj(p, cfg, o), {"k": k, "v": v}

    q, k, v = _project_qkv(p, cfg, x, positions)
    ka, va = _rank_kv(cfg, q, k, v)

    q_chunk = min(q_chunk, s)
    n_chunks = s // q_chunk if s % q_chunk == 0 else 0
    if n_chunks <= 1:
        out = _attend_block(cfg, q, ka, va, positions, positions)
    else:
        out = torch.cat([
            _attend_block(cfg, q[:, c:c + q_chunk], ka, va, positions[:, c:c + q_chunk],
                          positions)
            for c in range(0, s, q_chunk)
        ], dim=1)
    return _out_proj(p, cfg, out), {"k": k, "v": v}


def _attend_block(cfg, q, k, v, q_pos, k_pos):
    """q: (b,sq,qh,hd); k/v: (b,sk,kvh,hd); positions (b,sq)/(b,sk)."""
    scores = _gqa_scores(q, k)  # (b,kvh,g,sq,sk)
    mask = q_pos[:, :, None] >= k_pos[:, None, :]  # causal (b,sq,sk)
    if cfg.sliding_window:
        mask &= (q_pos[:, :, None] - k_pos[:, None, :]) < cfg.sliding_window
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    return _softmax_out(scores, v)


# --------------------------------------------------------------------- decode
def init_kv_cache(cfg, batch, seq_len, device):
    """Decode cache (one device's; `registry.init_cache(mesh=)` cuts it
    to a rank's batch rows and kv heads). Sliding window => ring buffer
    of window size."""
    L = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (batch, L, cfg.num_kv_heads, cfg.head_dim)
    dt = cdtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _slot(cfg, pos: int, L: int) -> int:
    """The cache slot of absolute position `pos`."""
    if cfg.sliding_window:
        return pos % L
    if not 0 <= pos < L:
        raise ValueError(f"decode position {pos} is outside the cache's {L} slots "
                         f"(no sliding window)")
    return pos


def _valid(cfg, pos: int, slot: int, L: int, device):
    """Which of the L cache slots hold a position the query may attend to."""
    idx = torch.arange(L, device=device)
    if cfg.sliding_window:
        # ring buffer: entry i holds absolute position p with p % L == i, the
        # latest such p <= pos. Valid iff that p is within the window.
        age = torch.remainder(slot - idx, L)  # a floor modulo, as jnp's %
        return age < min(pos + 1, L)
    return idx <= pos


def _decode_attend(p, cfg, q, ck, cv, pos, slot):
    L = ck.shape[1]
    ck, cv = _rank_kv(cfg, q, ck, cv)
    scores = _gqa_scores(q, ck)  # (b,kvh,g,1,L)
    valid = _valid(cfg, pos, slot, L, scores.device)
    scores = scores.masked_fill(~valid[None, None, None, None, :], NEG_INF)
    o = _softmax_out(scores, cv)
    return _out_proj(p, cfg, o)


def attention_decode(p, cfg, x, cache, pos, memory_cache=None):
    """One-token decode. x: (b, 1, d); pos: int (same for the batch).

    Returns (out (b,1,d), cache), the cache updated in place.
    ``memory_cache``: projected cross-attn K/V -> attends to it with no
    mask and does not update any cache.
    """
    if memory_cache is not None:
        q = _memory_q(p, cfg, enter_split(x, split_width(p["wq"].shape[-2], cfg.num_heads)))
        k, v = _rank_kv(cfg, q, memory_cache["k"], memory_cache["v"])
        o = _softmax_out(_gqa_scores(q, k), v)
        return _out_proj(p, cfg, o), cache

    pos = int(pos)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    L = cache["k"].shape[1]
    slot = _slot(cfg, pos, L)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    return _decode_attend(p, cfg, q, cache["k"], cache["v"], pos, slot), cache


def attention_decode_stacked(p, cfg, x, cache, pos, layer_idx):
    """Decode against a STACKED multi-layer cache {"k"/"v": (n_layers, b,
    L, kvh, hd)}: the new token's K/V are written into layer `layer_idx`
    of the stacked buffer in place. Returns (out (b,1,d), cache)."""
    pos = int(pos)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    L = cache["k"].shape[2]
    slot = _slot(cfg, pos, L)
    cache["k"][layer_idx, :, slot] = k[:, 0]
    cache["v"][layer_idx, :, slot] = v[:, 0]
    out = _decode_attend(p, cfg, q, cache["k"][layer_idx], cache["v"][layer_idx], pos, slot)
    return out, cache
