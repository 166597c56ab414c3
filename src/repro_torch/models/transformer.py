"""Decoder-only transformer stack with early-exit side branches (port of
`repro.models.transformer`).

The stack is organised into *segments*: maximal runs of layers with
identical (mixer, ffn) kind that do not cross an early-exit boundary. A
segment of n > 1 layers holds stacked ``(n, ...)`` params and, in decode,
a stacked ``(n, ...)`` cache; a segment of one layer holds neither. The
tree is the reference's, so `params_from_jax` is a structural map and
`edge_forward` / `cloud_forward` split at the same segment. Where the
reference scans over a stacked segment, the port loops over the layers'
``w[i]`` views in Python.

Early exits (the paper's technique): after segment boundaries listed in
cfg.exit_layers, an exit head (norm + unembed) produces side-branch
logits. The stack returns them all; gating/calibration live in
`repro_torch.core`.

Scope: the dense and vlm families, layer kinds ``("attn", "dense")`` and
``("attn", "none")``. A ``"moe"`` ffn or a ``"mamba"`` mixer raises
`NotImplementedError`. `forward_train` is forward-only (LM training,
with its activation checkpointing, is not ported yet). Decode updates
the caches in place (see `attention`).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch._device import as_tensor, require_device, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_embed,
    apply_mlp,
    apply_norm,
    apply_unembed,
    cdtype,
    init_embed,
    init_mlp,
    init_norm,
    init_unembed,
    matmul,
    normal,
)

_UNPORTED = {
    "moe": "a 'moe' ffn (models/moe) is not ported yet: ROADMAP.md queue 1 item 7b",
    "mamba": "a 'mamba' mixer (models/mamba and the hybrid) is not ported yet: "
             "ROADMAP.md queue 1 item 7c",
}


def _check_kind(kind):
    mixer, ffn = kind
    for part in (mixer, ffn):
        if part in _UNPORTED:
            raise NotImplementedError(_UNPORTED[part])


# ---------------------------------------------------------------- segmentation
def segment_plan(cfg: ModelConfig):
    """[(kind=(mixer,ffn), n_layers, exit_after: bool)] covering all layers."""
    plan = cfg.layer_plan()
    exits = set(cfg.exit_layers)
    segs = []
    start = 0
    for i in range(cfg.num_layers):
        boundary = (
            i + 1 == cfg.num_layers
            or plan[i + 1] != plan[i]
            or i in exits
        )
        if boundary:
            segs.append((plan[i], i - start + 1, i in exits))
            start = i + 1
    return segs


def _layer(tree, i):
    """Layer i's view of a stacked (n, ...) params or cache tree."""
    return pytree.tree_map(lambda a: a[i], tree)


# ------------------------------------------------------------------- one block
def init_block(generator, cfg, kind):
    _check_kind(kind)
    _, ffn = kind
    p: Dict[str, Any] = {"mixer_norm": init_norm(generator, cfg)}
    p["attn"] = attn.init_attention(generator, cfg)
    if ffn != "none":
        p["ffn_norm"] = init_norm(generator, cfg)
        p["mlp"] = init_mlp(generator, cfg)
    return p


def _ffn(p, cfg, ffn, x):
    if ffn != "none":
        x = x + apply_mlp(p["mlp"], cfg, apply_norm(p["ffn_norm"], cfg, x))
    return x


def apply_block_seq(p, cfg, kind, x, positions):
    """Full-sequence (train/prefill) block. Returns (x, cache, aux)."""
    _check_kind(kind)
    h = apply_norm(p["mixer_norm"], cfg, x)
    h, cache = attn.attention_prefill(p["attn"], cfg, h, positions)
    x = _ffn(p, cfg, kind[1], x + h)
    return x, cache, {}


def apply_block_decode(p, cfg, kind, x, cache, pos):
    _check_kind(kind)
    h = apply_norm(p["mixer_norm"], cfg, x)
    h, cache = attn.attention_decode(p["attn"], cfg, h, cache, pos)
    return _ffn(p, cfg, kind[1], x + h), cache


def _apply_block_decode_stacked(p, cfg, kind, x, cache, pos, layer_idx):
    """Unrolled-decode block against a stacked (n_layers, ...) cache."""
    _check_kind(kind)
    h = apply_norm(p["mixer_norm"], cfg, x)
    h, cache = attn.attention_decode_stacked(p["attn"], cfg, h, cache, pos, layer_idx)
    return _ffn(p, cfg, kind[1], x + h), cache


def init_block_cache(cfg, kind, batch, seq_len, device):
    _check_kind(kind)
    return attn.init_kv_cache(cfg, batch, seq_len, device)


# ------------------------------------------------------------------- the model
def _init_segment(generator, cfg, kind, n):
    """One block's params, or n blocks' stacked (n, ...) params, filled
    layer by layer so no more than one layer is held twice."""
    first = init_block(generator, cfg, kind)
    if n == 1:
        return first
    stacked = pytree.tree_map(lambda a: a.new_empty((n,) + a.shape), first)
    for i in range(n):
        layer = first if i == 0 else init_block(generator, cfg, kind)
        pytree.tree_map(lambda dst, src: dst.copy_(src), _layer(stacked, i), layer)
    return stacked


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None):
    """Random params with the reference's distributions, drawn from
    `generator` (on `device`, ``cuda`` by default; None seeds a fresh one
    with 0). A generator on another device raises ValueError: the params
    are drawn where the generator lives."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    require_device(generator.device, device, "the generator's draws")
    params: Dict[str, Any] = {"embed": init_embed(generator, cfg)}
    if cfg.max_position_embeddings:
        params["pos_embed"] = normal(generator, (cfg.max_position_embeddings, cfg.d_model),
                                     0.02, cdtype(cfg))
    params["segments"] = [_init_segment(generator, cfg, kind, n)
                          for kind, n, _ in segment_plan(cfg)]
    params["final_norm"] = init_norm(generator, cfg)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_unembed(generator, cfg)
    params["exits"] = [
        {"norm": init_norm(generator, cfg), "head": init_unembed(generator, cfg)}
        for _ in cfg.exit_layers
    ]
    return params


def params_from_jax(tree, device=None):
    """Carry a reference parameter tree (nested dicts and lists of arrays)
    across as it is: bfloat16 leaves (ml_dtypes arrays in numpy) go
    through float32 to torch bfloat16, which is exact; float32 leaves stay
    float32. Lands on `device` (``cuda`` by default)."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        a = np.asarray(node)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)

    return convert(tree)


def num_params(params) -> int:
    """Number of scalars in a params tree."""
    return sum(a.numel() for a in pytree.tree_leaves(params))


def _lm_logits(params, cfg, x):
    h = apply_norm(params["final_norm"], cfg, x)
    if cfg.tie_embeddings:
        return matmul(h, params["embed"]["w"].T)
    return apply_unembed(params["lm_head"], h)


def exit_logits_fn(params, cfg, i, x):
    ep = params["exits"][i]
    return apply_unembed(ep["head"], apply_norm(ep["norm"], cfg, x))


def _embed(params, cfg, tokens):
    """(x (b, s, d), positions (b, s)) for a (b, s) token batch, on the
    params' device."""
    dev = params["embed"]["w"].device
    tokens = as_tensor(tokens, dev).to(device=dev, dtype=torch.int64)
    b, s = tokens.shape
    x = apply_embed(params["embed"], tokens)
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    if cfg.max_position_embeddings:
        x = x + params["pos_embed"][:s][None]
    return x, positions


def _run_segment_seq(sp, cfg, kind, n, x, positions, keep_cache=True):
    """One segment over a full sequence. Returns (x, cache), the cache
    stacked (n, ...) when n > 1, or None unless `keep_cache`."""
    if n == 1:
        x, cache, _ = apply_block_seq(sp, cfg, kind, x, positions)
        return x, cache if keep_cache else None
    caches = []
    for i in range(n):
        x, cache, _ = apply_block_seq(_layer(sp, i), cfg, kind, x, positions)
        if keep_cache:
            caches.append(cache)
    return x, pytree.tree_map(lambda *a: torch.stack(a), *caches) if keep_cache else None


def _run_segments_seq(params, cfg, x, positions, keep_cache):
    """Returns (x, exit_hiddens, caches)."""
    exit_hiddens: List[Any] = []
    caches: List[Any] = []
    for sp, (kind, n, exit_after) in zip(params["segments"], segment_plan(cfg)):
        x, cache = _run_segment_seq(sp, cfg, kind, n, x, positions, keep_cache)
        caches.append(cache)
        if exit_after:
            exit_hiddens.append(x)
    return x, exit_hiddens, caches


def forward_train(params, cfg: ModelConfig, batch):
    """batch: {tokens (b, s) int, ...}. Returns logits dict for the loss
    (forward only; `moe_aux_loss` is 0 for the ported families)."""
    x, positions = _embed(params, cfg, batch["tokens"])
    x, exit_hiddens, _ = _run_segments_seq(params, cfg, x, positions, keep_cache=False)
    return {
        "logits": _lm_logits(params, cfg, x),
        "exit_logits": [exit_logits_fn(params, cfg, i, h) for i, h in enumerate(exit_hiddens)],
        "moe_aux_loss": torch.zeros((), dtype=torch.float32, device=x.device),
    }


def forward_prefill(params, cfg: ModelConfig, batch):
    """Prefill: full sequence, returns last-position logits + caches + exits."""
    x, positions = _embed(params, cfg, batch["tokens"])
    x, exit_hiddens, caches = _run_segments_seq(params, cfg, x, positions, keep_cache=True)
    return {
        "logits": _lm_logits(params, cfg, x[:, -1:, :]),
        "exit_logits": [exit_logits_fn(params, cfg, i, h[:, -1:, :])
                        for i, h in enumerate(exit_hiddens)],
        "caches": caches,
    }


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Zeroed decode caches, one per segment (stacked (n, ...) when n > 1),
    on `device` (``cuda`` by default)."""
    device = resolve_device(device)
    caches = []
    for kind, n, _ in segment_plan(cfg):
        c = init_block_cache(cfg, kind, batch, seq_len, device)
        if n > 1:
            c = pytree.tree_map(lambda a: a.new_zeros((n,) + a.shape), c)
        caches.append(c)
    return caches


def decode_step(params, cfg: ModelConfig, token, caches, pos):
    """token: (b, 1) int; pos: int. Returns (out, caches), the caches
    updated in place.

    out: {"logits": (b,1,V), "exit_logits": [(b,1,V)...]}
    """
    dev = params["embed"]["w"].device
    token = as_tensor(token, dev).to(device=dev, dtype=torch.int64)
    pos = int(pos)
    x = apply_embed(params["embed"], token)
    if cfg.max_position_embeddings:
        x = x + params["pos_embed"][pos][None, None, :]
    exit_hiddens = []
    for sp, cache, (kind, n, exit_after) in zip(params["segments"], caches, segment_plan(cfg)):
        if n == 1:
            x, _ = apply_block_decode(sp, cfg, kind, x, cache, pos)
        elif cfg.decode_unroll:
            for i in range(n):
                x, _ = _apply_block_decode_stacked(_layer(sp, i), cfg, kind, x, cache, pos, i)
        else:
            for i in range(n):  # layer i's cache views write through to the stack
                x, _ = apply_block_decode(_layer(sp, i), cfg, kind, x, _layer(cache, i), pos)
        if exit_after:
            exit_hiddens.append(x)
    logits = _lm_logits(params, cfg, x)
    ex_logits = [exit_logits_fn(params, cfg, i, h) for i, h in enumerate(exit_hiddens)]
    return {"logits": logits, "exit_logits": ex_logits}, caches


# ----------------------------------------------------- partitioned execution
def edge_forward(params, cfg: ModelConfig, batch, exit_index: int = 0):
    """The *edge partition*: blocks up to exit `exit_index` + that exit head.

    Returns {"exit_logits": (b,1,V) last position, "hidden": (b,s,d), "caches"}.
    The hidden is the partition payload the offloading engine ships to the
    cloud partition when the gate refuses the sample.
    """
    x, positions = _embed(params, cfg, batch["tokens"])
    caches = []
    n_exits_seen = 0
    for sp, (kind, n, exit_after) in zip(params["segments"], segment_plan(cfg)):
        x, cache = _run_segment_seq(sp, cfg, kind, n, x, positions)
        caches.append(cache)
        if exit_after:
            if n_exits_seen == exit_index:
                logits = exit_logits_fn(params, cfg, n_exits_seen, x[:, -1:, :])
                return {"exit_logits": logits, "hidden": x, "caches": caches}
            n_exits_seen += 1
    raise ValueError(f"exit_index {exit_index} not found in {cfg.name}")


def cloud_forward(params, cfg: ModelConfig, hidden, exit_index: int = 0):
    """The *cloud partition*: remaining blocks after exit `exit_index`.
    A float32 `hidden` (a decoded codec payload) runs the partition in
    float32 against bf16 weights, each weight cast up per product."""
    b, s, _ = hidden.shape
    positions = torch.arange(s, dtype=torch.int32, device=hidden.device).expand(b, s)
    x = hidden
    n_exits_seen = 0
    started = False
    for sp, (kind, n, exit_after) in zip(params["segments"], segment_plan(cfg)):
        if started:
            x, _ = _run_segment_seq(sp, cfg, kind, n, x, positions, keep_cache=False)
        if exit_after and not started:
            if n_exits_seen == exit_index:
                started = True
            n_exits_seen += 1
    return {"logits": _lm_logits(params, cfg, x[:, -1:, :])}
