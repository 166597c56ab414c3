"""Decoder-only transformer stack with early-exit side branches (port of
`repro.models.transformer`).

The stack is organised into *segments*: maximal runs of layers with
identical (mixer, ffn) kind that do not cross an early-exit boundary. A
segment of n > 1 layers holds stacked ``(n, ...)`` params and, in decode,
a stacked ``(n, ...)`` cache; a segment of one layer holds neither. The
tree is the reference's, so `params_from_jax` is a structural map and
`edge_forward` / `cloud_forward` split at the same segment. Where the
reference scans over a stacked segment, the port loops over the layers'
views in Python.

Early exits (the paper's technique): after segment boundaries listed in
cfg.exit_layers, an exit head (norm + unembed) produces side-branch
logits. The stack returns them all; gating/calibration live in
`repro_torch.core`.

The decoder-only families (the encoder-decoder is `models.whisper`): layer kinds
``(mixer, ffn)`` with an ``"attn"`` or ``"mamba"`` mixer and a
``"dense"``, ``"moe"`` or ``"none"`` ffn. `forward_train` is
differentiable: with ``remat`` each single-layer segment and each layer
of a stacked segment is checkpointed (`torch.utils.checkpoint`, the
reference's `jax.checkpoint` places), and the MoE aux loss is summed over
the layers. A stacked segment's leaves are unbound once per pass
(`_layers`): the backward of `torch.unbind` is one stack, where a select
per layer would materialise a zero tensor of the whole stack per layer.
Decode updates the caches in place (see `attention` and `mamba`).

Tensor parallelism: `init_params(mesh=)` and `params_from_jax(mesh=)`
give a rank its slices (`sharding.local_shards` under
`sharding.layout_specs`), drawn layer by layer from the one-device
stream, so no rank holds more than one layer whole;
`registry.init_cache(mesh=)` allocates its batch rows, kv heads and SSD
heads. Run under `sharding.use_mesh`, the forward passes split heads,
``d_ff``, experts, mamba's SSD heads and the vocabulary over the model
axis (`layers`, `attention`, `moe`, `mamba`); the logits come out of
the heads as vocab shards, as the reference constrains them ("dp",
None, "tp"), and are gathered (`gather_vocab`) where one device's whole
rows are needed: the exit logits before their gates, the prefill's and
the cloud partition's final logits. Decode keeps its final logits as
this rank's shard; `vocab_argmax` takes the global argmax from the
shards. `forward_train` returns every head's logits as this rank's vocab
shard (the loss is vocab-parallel, `training.losses.softmax_xent`); the
heads' input enters the split through `layers.enter_split`, and
`gather_vocab` is differentiable (`launch.mesh.model_gather`).

Under a `torch.profiler.profile` the full-sequence blocks carry the spans
``lm.mixer`` (the mixer's norm and attention or mamba) and ``lm.ffn``
(the residual, the ffn's norm, MLP or MoE, and its residual), and
`edge_forward` and `cloud_forward` carry ``lm.head`` around their head
and its vocabulary gather (`repro_torch.obs.span`: none is entered with
no profiler on).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch._device import as_tensor, require_device, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import gather_blocks, model_gather
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models.layers import (
    apply_embed,
    apply_mlp,
    apply_norm,
    apply_unembed,
    cdtype,
    enter_split,
    init_embed,
    init_mlp,
    init_norm,
    init_unembed,
    matmul,
    normal,
    split_width,
)
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.obs import span


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


def _layers(tree, n):
    """The n layers' views of a stacked (n, ...) tree, each leaf unbound
    once."""
    leaves, spec = pytree.tree_flatten(tree)
    per_leaf = [torch.unbind(a) for a in leaves]
    return [pytree.tree_unflatten([u[i] for u in per_leaf], spec) for i in range(n)]


# ------------------------------------------------------------------- one block
def init_block(generator, cfg, kind):
    mixer, ffn = kind
    p: Dict[str, Any] = {"mixer_norm": init_norm(generator, cfg)}
    if mixer == "attn":
        p["attn"] = attn.init_attention(generator, cfg)
    else:
        p["mamba"] = mb.init_mamba(generator, cfg)
    if ffn != "none":
        p["ffn_norm"] = init_norm(generator, cfg)
        if ffn == "dense":
            p["mlp"] = init_mlp(generator, cfg)
        else:
            p["moe"] = init_moe(generator, cfg)
    return p


def _ffn(p, cfg, ffn, x):
    """The block's ffn half with its residual. Returns (x, aux)."""
    if ffn == "none":
        return x, {}
    h = apply_norm(p["ffn_norm"], cfg, x)
    if ffn == "dense":
        return x + apply_mlp(p["mlp"], cfg, h), {}
    h, aux = apply_moe(p["moe"], cfg, h)
    return x + h, aux


def apply_block_seq(p, cfg, kind, x, positions):
    """Full-sequence (train/prefill) block. Returns (x, cache, aux)."""
    mixer, ffn = kind
    with span("lm.mixer"):
        h = apply_norm(p["mixer_norm"], cfg, x)
        if mixer == "attn":
            h, cache = attn.attention_prefill(p["attn"], cfg, h, positions)
        else:
            h, cache = mb.mamba_prefill(p["mamba"], cfg, h)
    with span("lm.ffn"):
        x, aux = _ffn(p, cfg, ffn, x + h)
    return x, cache, aux


def apply_block_decode(p, cfg, kind, x, cache, pos):
    mixer, ffn = kind
    h = apply_norm(p["mixer_norm"], cfg, x)
    if mixer == "attn":
        h, cache = attn.attention_decode(p["attn"], cfg, h, cache, pos)
    else:
        h, cache = mb.mamba_decode(p["mamba"], cfg, h, cache)
    return _ffn(p, cfg, ffn, x + h)[0], cache


def _apply_block_decode_stacked(p, cfg, kind, x, cache, pos, layer_idx):
    """Unrolled-decode block against a stacked (n_layers, ...) cache,
    layer `layer_idx`'s slice updated in place."""
    mixer, ffn = kind
    h = apply_norm(p["mixer_norm"], cfg, x)
    if mixer == "attn":
        h, cache = attn.attention_decode_stacked(p["attn"], cfg, h, cache, pos, layer_idx)
    else:
        # the mamba state IS the layer's whole payload: its views write through
        h, _ = mb.mamba_decode(p["mamba"], cfg, h, _layer(cache, layer_idx))
    return _ffn(p, cfg, ffn, x + h)[0], cache


def init_block_cache(cfg, kind, batch, seq_len, device):
    if kind[0] == "attn":
        return attn.init_kv_cache(cfg, batch, seq_len, device)
    return mb.init_mamba_cache(cfg, batch, device)


# ------------------------------------------------------------------- the model
def _init_segment(generator, cfg, kind, n, cut=lambda tree: tree):
    """One block's params, or n blocks' stacked (n, ...) params, filled
    layer by layer so no more than one layer is held twice; `cut` keeps a
    rank's slices of each layer as it is drawn."""
    first = cut(init_block(generator, cfg, kind))
    if n == 1:
        return first
    stacked = pytree.tree_map(lambda a: a.new_empty((n,) + a.shape), first)
    for i in range(n):
        layer = first if i == 0 else cut(init_block(generator, cfg, kind))
        pytree.tree_map(lambda dst, src: dst.copy_(src), _layer(stacked, i), layer)
    return stacked


def _cutter(mesh):
    """-> cut(tree): this rank's `sharding.local_shards` of a params
    subtree under `sharding.layout_specs` (its paths end as the full
    tree's do, so the same rules match, and a mamba layer's leaves are
    cut together); no mesh keeps the tree whole."""
    if mesh is None:
        return lambda tree: tree
    return lambda tree: sharding.local_shards(tree, sharding.layout_specs(tree, mesh), mesh)


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None, mesh=None):
    """Random params with the reference's distributions, drawn from
    `generator` (on `device`, ``cuda`` by default; None seeds a fresh one
    with 0). A generator on another device raises ValueError: the params
    are drawn where the generator lives.

    With `mesh` (this rank's coordinates known) each rank draws the
    one-device stream leaf by leaf and keeps its slices under
    `sharding.layout_specs`: bit for bit its block of the one-device
    params, never holding more than one layer whole."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    require_device(generator.device, device, "the generator's draws")
    cut = _cutter(mesh)
    params: Dict[str, Any] = cut({"embed": init_embed(generator, cfg)})
    if cfg.max_position_embeddings:
        params["pos_embed"] = normal(generator, (cfg.max_position_embeddings, cfg.d_model),
                                     0.02, cdtype(cfg))
    params["segments"] = [_init_segment(generator, cfg, kind, n, cut)
                          for kind, n, _ in segment_plan(cfg)]
    params["final_norm"] = init_norm(generator, cfg)
    if not cfg.tie_embeddings:
        params["lm_head"] = cut({"lm_head": init_unembed(generator, cfg)})["lm_head"]
    params["exits"] = [
        cut({"norm": init_norm(generator, cfg), "head": init_unembed(generator, cfg)})
        for _ in cfg.exit_layers
    ]
    return params


def params_from_jax(tree, device=None, mesh=None):
    """Carry a reference parameter tree (nested dicts and lists of arrays)
    across as it is: bfloat16 leaves (ml_dtypes arrays in numpy) go
    through float32 to torch bfloat16, which is exact; float32 leaves stay
    float32. Lands on `device` (``cuda`` by default). With `mesh` only
    this rank's slices (`sharding.local_shards`) are carried."""
    device = resolve_device(device)
    if mesh is not None:
        tree = pytree.tree_map(np.asarray, tree)
        tree = sharding.local_shards(tree, sharding.layout_specs(tree, mesh), mesh)

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


def lm_logits(params, cfg, x):
    """The final head's logits: this rank's vocab shard under a model axis
    (column-parallel; the tied embedding's rows are its vocab)."""
    h = apply_norm(params["final_norm"], cfg, x)
    w = params["embed"]["w"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    return matmul(enter_split(h, split_width(w.shape[-1], cfg.vocab_size)), w)


def exit_logits_fn(params, cfg, i, x):
    """Exit `i`'s logits: this rank's vocab shard under a model axis."""
    ep = params["exits"][i]
    h = apply_norm(ep["norm"], cfg, x)
    return apply_unembed(ep["head"], enter_split(h, split_width(ep["head"]["w"].shape[-1],
                                                                cfg.vocab_size)))


def gather_vocab(logits, cfg):
    """Whole (..., V) rows from this rank's vocab shards (one all-reduce
    of the ranks' blocks, exact; the gradient is cut back to the shard);
    logits that are whole pass through."""
    split = split_width(logits.shape[-1], cfg.vocab_size)
    if split is None:
        return logits
    group, index, n = split
    return model_gather(logits, index, n, group, dim=-1)


def vocab_argmax(logits, cfg):
    """argmax over the whole vocabulary of (..., V) logits or of this
    rank's vocab shard of them, in float32, ties to the lowest index as
    `torch.argmax` breaks them: each shard's (max, argmax) is gathered and
    the lowest index among the shards holding the global max wins."""
    z = logits.to(torch.float32)
    split = split_width(z.shape[-1], cfg.vocab_size)
    if split is None:
        return torch.argmax(z, dim=-1)
    group, index, n = split
    a = torch.argmax(z, dim=-1, keepdim=True)
    stats = torch.cat([z.gather(-1, a).double(), (a + index * z.shape[-1]).double()], dim=-1)
    every = gather_blocks(stats, index, n, group)  # (n, ..., 2), exact in float64
    m, i = every[..., 0], every[..., 1]
    best = torch.where(m == m.amax(dim=0), i, torch.inf).amin(dim=0)
    return best.to(torch.int64)


def _embed(params, cfg, tokens):
    """(x (b, s, d), positions (b, s)) for a (b, s) token batch, on the
    params' device."""
    dev = params["embed"]["w"].device
    tokens = as_tensor(tokens, dev).to(device=dev, dtype=torch.int64)
    b, s = tokens.shape
    x = apply_embed(params["embed"], tokens, cfg.vocab_size)
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    if cfg.max_position_embeddings:
        x = x + params["pos_embed"][:s][None]
    return x, positions


def _run_segment_seq(sp, cfg, kind, n, x, positions, keep_cache=True, remat=False):
    """One segment over a full sequence. Returns (x, cache, aux_sum): the
    cache stacked (n, ...) when n > 1, or None unless `keep_cache`; the
    layers' MoE aux losses summed (float32). With `remat` each layer is
    checkpointed."""
    caches = []
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in [sp] if n == 1 else _layers(sp, n):
        if remat:
            x, cache, aux = checkpoint(apply_block_seq, lp, cfg, kind, x, positions,
                                       use_reentrant=False)
        else:
            x, cache, aux = apply_block_seq(lp, cfg, kind, x, positions)
        if "moe_aux_loss" in aux:
            aux_sum = aux_sum + aux["moe_aux_loss"]
        if keep_cache:
            caches.append(cache)
    if not keep_cache:
        return x, None, aux_sum
    return x, caches[0] if n == 1 else pytree.tree_map(lambda *a: torch.stack(a), *caches), \
        aux_sum


def _run_segments_seq(params, cfg, x, positions, keep_cache, remat=False):
    """Returns (x, exit_hiddens, aux_sum, caches)."""
    exit_hiddens: List[Any] = []
    caches: List[Any] = []
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for sp, (kind, n, exit_after) in zip(params["segments"], segment_plan(cfg)):
        x, cache, aux = _run_segment_seq(sp, cfg, kind, n, x, positions, keep_cache, remat)
        aux_sum = aux_sum + aux
        caches.append(cache)
        if exit_after:
            exit_hiddens.append(x)
    return x, exit_hiddens, aux_sum, caches


def forward_train(params, cfg: ModelConfig, batch, remat: bool = True):
    """batch: {tokens (b, s) int, ...}. Returns logits dict for the loss,
    differentiable; `moe_aux_loss` is the layers' sum."""
    x, positions = _embed(params, cfg, batch["tokens"])
    x, exit_hiddens, aux_sum, _ = _run_segments_seq(params, cfg, x, positions,
                                                    keep_cache=False, remat=remat)
    return {
        "logits": lm_logits(params, cfg, x),
        "exit_logits": [exit_logits_fn(params, cfg, i, h) for i, h in enumerate(exit_hiddens)],
        "moe_aux_loss": aux_sum,
    }


def forward_prefill(params, cfg: ModelConfig, batch):
    """Prefill: full sequence, returns last-position logits + caches + exits."""
    x, positions = _embed(params, cfg, batch["tokens"])
    x, exit_hiddens, _, caches = _run_segments_seq(params, cfg, x, positions, keep_cache=True)
    return {
        "logits": gather_vocab(lm_logits(params, cfg, x[:, -1:, :]), cfg),
        "exit_logits": [gather_vocab(exit_logits_fn(params, cfg, i, h[:, -1:, :]), cfg)
                        for i, h in enumerate(exit_hiddens)],
        "caches": caches,
    }


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Zeroed decode caches, one per segment (stacked (n, ...) when n > 1),
    on `device` (``cuda`` by default); `registry.init_cache(mesh=)` gives a
    rank its part of them."""
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

    out: {"logits": (b,1,V), "exit_logits": [(b,1,V)...]}; under a model
    axis "logits" is this rank's vocab shard (`vocab_argmax`).
    """
    dev = params["embed"]["w"].device
    token = as_tensor(token, dev).to(device=dev, dtype=torch.int64)
    pos = int(pos)
    x = apply_embed(params["embed"], token, cfg.vocab_size)
    if cfg.max_position_embeddings:
        x = x + params["pos_embed"][pos][None, None, :]
    exit_hiddens = []
    for sp, cache, (kind, n, exit_after) in zip(params["segments"], caches, segment_plan(cfg)):
        if n == 1:
            x, _ = apply_block_decode(sp, cfg, kind, x, cache, pos)
        elif cfg.decode_unroll:
            for i, lp in enumerate(_layers(sp, n)):
                x, _ = _apply_block_decode_stacked(lp, cfg, kind, x, cache, pos, i)
        else:  # layer i's cache views write through to the stack
            for lp, lc in zip(_layers(sp, n), _layers(cache, n)):
                x, _ = apply_block_decode(lp, cfg, kind, x, lc, pos)
        if exit_after:
            exit_hiddens.append(x)
    logits = lm_logits(params, cfg, x)
    ex_logits = [gather_vocab(exit_logits_fn(params, cfg, i, h), cfg)
                 for i, h in enumerate(exit_hiddens)]
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
        x, cache, _ = _run_segment_seq(sp, cfg, kind, n, x, positions)
        caches.append(cache)
        if exit_after:
            if n_exits_seen == exit_index:
                with span("lm.head"):
                    logits = gather_vocab(exit_logits_fn(params, cfg, n_exits_seen,
                                                         x[:, -1:, :]), cfg)
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
            x, _, _ = _run_segment_seq(sp, cfg, kind, n, x, positions, keep_cache=False)
        if exit_after and not started:
            if n_exits_seen == exit_index:
                started = True
            n_exits_seen += 1
    with span("lm.head"):
        return {"logits": gather_vocab(lm_logits(params, cfg, x[:, -1:, :]), cfg)}
