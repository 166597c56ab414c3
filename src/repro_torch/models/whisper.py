"""Whisper-style encoder-decoder backbone, audio frontend stubbed (port of
`repro.models.whisper`).

``batch["encoder_frames"]`` holds precomputed frame embeddings of shape
(batch, encoder_seq, d_model) in place of the mel-spectrogram and conv
feature extractor. The backbone: a bidirectional encoder over the frames
and a causal decoder with cross-attention to the encoder memory, learned
absolute position embeddings, LayerNorm + GELU, and early-exit side
branches on decoder blocks.

`forward_train` is differentiable and, with ``remat``, checkpoints each
decoder block (the reference's `jax.checkpoint` place). Decode updates
the self-attention caches in place; the cross caches hold the projected
encoder memory and are only read.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import as_tensor, require_device, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_embed,
    apply_mlp,
    apply_norm,
    apply_unembed,
    cdtype,
    einsum,
    init_embed,
    init_mlp,
    init_norm,
    init_unembed,
    normal,
)
# a reference whisper tree carries across as any other
from repro_torch.models.transformer import params_from_jax  # noqa: F401


def _init_enc_block(generator, cfg):
    return {
        "mixer_norm": init_norm(generator, cfg),
        "attn": attn.init_attention(generator, cfg),
        "ffn_norm": init_norm(generator, cfg),
        "mlp": init_mlp(generator, cfg),
    }


def _init_dec_block(generator, cfg):
    return {
        "mixer_norm": init_norm(generator, cfg),
        "attn": attn.init_attention(generator, cfg),
        "cross_norm": init_norm(generator, cfg),
        "cross_attn": attn.init_attention(generator, cfg),
        "ffn_norm": init_norm(generator, cfg),
        "mlp": init_mlp(generator, cfg),
    }


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None):
    """Random params with the reference's distributions, drawn from
    `generator` on `device` (``cuda`` by default; None seeds a fresh one
    with 0). A generator on another device raises ValueError."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    require_device(generator.device, device, "the generator's draws")
    dt = cdtype(cfg)
    params: Dict[str, Any] = {
        "embed": init_embed(generator, cfg),
        "enc_pos_embed": normal(generator, (cfg.encoder_seq, cfg.d_model), 0.02, dt),
        "pos_embed": normal(generator, (cfg.max_position_embeddings, cfg.d_model), 0.02, dt),
        "enc_blocks": [_init_enc_block(generator, cfg) for _ in range(cfg.encoder_layers)],
        "dec_blocks": [_init_dec_block(generator, cfg) for _ in range(cfg.num_layers)],
        "enc_final_norm": init_norm(generator, cfg),
        "final_norm": init_norm(generator, cfg),
        "lm_head": init_unembed(generator, cfg),
    }
    params["exits"] = [
        {"norm": init_norm(generator, cfg), "head": init_unembed(generator, cfg)}
        for _ in cfg.exit_layers
    ]
    return params


def _positions(b, s, device):
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def encode(params, cfg, frames):
    """frames: (b, enc_seq, d) stubbed frontend output -> encoder memory."""
    dev = params["embed"]["w"].device
    x = as_tensor(frames, dev) + params["enc_pos_embed"][None]
    b, s, _ = x.shape
    positions = _positions(b, s, dev)
    for blk in params["enc_blocks"]:
        h = apply_norm(blk["mixer_norm"], cfg, x)
        # bidirectional: memory=h, so no causal mask is applied
        h, _ = attn.attention_prefill(blk["attn"], cfg, h, positions, memory=h)
        x = x + h
        h = apply_norm(blk["ffn_norm"], cfg, x)
        x = x + apply_mlp(blk["mlp"], cfg, h)
    return apply_norm(params["enc_final_norm"], cfg, x)


def _dec_block_seq(blk, cfg, x, positions, memory):
    h = apply_norm(blk["mixer_norm"], cfg, x)
    h, cache = attn.attention_prefill(blk["attn"], cfg, h, positions)
    x = x + h
    h = apply_norm(blk["cross_norm"], cfg, x)
    h, xcache = attn.attention_prefill(blk["cross_attn"], cfg, h, positions, memory=memory)
    x = x + h
    h = apply_norm(blk["ffn_norm"], cfg, x)
    return x + apply_mlp(blk["mlp"], cfg, h), cache, xcache


def _embed(params, tokens):
    dev = params["embed"]["w"].device
    tokens = as_tensor(tokens, dev).to(device=dev, dtype=torch.int64)
    b, s = tokens.shape
    x = apply_embed(params["embed"], tokens) + params["pos_embed"][:s][None]
    return x, _positions(b, s, dev)


def _head(p, cfg, x):
    return apply_unembed(p["head"], apply_norm(p["norm"], cfg, x))


def forward_train(params, cfg: ModelConfig, batch, remat: bool = True):
    """batch: {tokens (b,s), encoder_frames (b,enc_seq,d)}."""
    memory = encode(params, cfg, batch["encoder_frames"])
    x, positions = _embed(params, batch["tokens"])
    exit_hiddens = []
    exits = set(cfg.exit_layers)
    for i, blk in enumerate(params["dec_blocks"]):
        if remat:
            x, _, _ = checkpoint(_dec_block_seq, blk, cfg, x, positions, memory,
                                 use_reentrant=False)
        else:
            x, _, _ = _dec_block_seq(blk, cfg, x, positions, memory)
        if i in exits:
            exit_hiddens.append(x)
    logits = apply_unembed(params["lm_head"], apply_norm(params["final_norm"], cfg, x))
    return {
        "logits": logits,
        "exit_logits": [_head(params["exits"][i], cfg, h) for i, h in enumerate(exit_hiddens)],
        "moe_aux_loss": torch.zeros((), dtype=torch.float32, device=x.device),
    }


def forward_prefill(params, cfg: ModelConfig, batch):
    """Serving prefill: encode frames + teacher-forced decoder pass.

    Returns last-position logits, per-exit last-position logits, and the
    decode caches (self-attn KV + projected cross-attn memory)."""
    memory = encode(params, cfg, batch["encoder_frames"])
    x, positions = _embed(params, batch["tokens"])
    exits = set(cfg.exit_layers)
    exit_hiddens = []
    self_caches, cross_caches = [], []
    for i, blk in enumerate(params["dec_blocks"]):
        x, cache, xcache = _dec_block_seq(blk, cfg, x, positions, memory)
        self_caches.append(cache)
        cross_caches.append(xcache)
        if i in exits:
            exit_hiddens.append(x)
    logits = apply_unembed(params["lm_head"], apply_norm(params["final_norm"], cfg, x[:, -1:, :]))
    return {
        "logits": logits,
        "exit_logits": [_head(params["exits"][i], cfg, h[:, -1:, :])
                        for i, h in enumerate(exit_hiddens)],
        "caches": {"self": self_caches, "cross": cross_caches},
    }


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Zeroed self-attn KV caches and cross-attn memory caches on `device`
    (``cuda`` by default)."""
    device = resolve_device(device)
    shape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    dt = cdtype(cfg)
    return {
        "self": [attn.init_kv_cache(cfg, batch, seq_len, device) for _ in range(cfg.num_layers)],
        "cross": [{"k": torch.zeros(shape, dtype=dt, device=device),
                   "v": torch.zeros(shape, dtype=dt, device=device)}
                  for _ in range(cfg.num_layers)],
    }


def prefill_cross_caches(params, cfg, frames):
    """Encode + project cross-attn K/V once per request (serving)."""
    memory = encode(params, cfg, frames)
    return [{"k": einsum("bsd,dhk->bshk", memory, blk["cross_attn"]["wk"]),
             "v": einsum("bsd,dhk->bshk", memory, blk["cross_attn"]["wv"])}
            for blk in params["dec_blocks"]]


def decode_step(params, cfg: ModelConfig, token, caches, pos):
    """token: (b, 1) int; pos: int. Returns (out, caches), the self caches
    updated in place."""
    dev = params["embed"]["w"].device
    token = as_tensor(token, dev).to(device=dev, dtype=torch.int64)
    pos = int(pos)
    x = apply_embed(params["embed"], token) + params["pos_embed"][pos][None, None, :]
    exits = set(cfg.exit_layers)
    exit_hiddens = []
    for i, blk in enumerate(params["dec_blocks"]):
        h = apply_norm(blk["mixer_norm"], cfg, x)
        h, _ = attn.attention_decode(blk["attn"], cfg, h, caches["self"][i], pos)
        x = x + h
        h = apply_norm(blk["cross_norm"], cfg, x)
        h, _ = attn.attention_decode(blk["cross_attn"], cfg, h, None, pos,
                                     memory_cache=caches["cross"][i])
        x = x + h
        h = apply_norm(blk["ffn_norm"], cfg, x)
        x = x + apply_mlp(blk["mlp"], cfg, h)
        if i in exits:
            exit_hiddens.append(x)
    logits = apply_unembed(params["lm_head"], apply_norm(params["final_norm"], cfg, x))
    ex_logits = [_head(params["exits"][i], cfg, h) for i, h in enumerate(exit_hiddens)]
    return {"logits": logits, "exit_logits": ex_logits}, caches
