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

Tensor parallelism, as `models.transformer` describes it:
`init_params(mesh=)` and `params_from_jax(mesh=)` give a rank its slices
under `sharding.layout_specs` (the reference's rules: the encoder's, the
decoder's and the cross-attention's heads and ``d_ff`` split, the
embedding and the heads vocab-parallel where the model axis divides the
vocabulary, ``pos_embed`` and ``enc_pos_embed`` and the LayerNorms
whole), and `registry.init_cache(mesh=)` the kv heads of its self and
cross caches. Under `sharding.use_mesh` the attention and MLP blocks
run on the rank's heads and ``d_ff`` block (`models.attention`,
`models.layers`). The encoder's output enters the decoder's split once
(`layers.enter_split`): the cross-attention k/v projections of every
decoder block read it, so its gradient, partial on each rank, is summed
over the model axis once for all of them. The logits leave the heads as
in `transformer`: `forward_train` returns this rank's vocab shards (the
loss is vocab-parallel), `forward_prefill` whole rows, `decode_step`
this rank's shard of the final logits and whole exit logits.
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
    cdtype,
    einsum,
    enter_split,
    init_embed,
    init_mlp,
    init_norm,
    init_unembed,
    normal,
    split_width,
)
from repro_torch.models.transformer import _cutter, exit_logits_fn, gather_vocab, lm_logits
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


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None, mesh=None):
    """Random params with the reference's distributions, drawn from
    `generator` on `device` (``cuda`` by default; None seeds a fresh one
    with 0). A generator on another device raises ValueError.

    With `mesh` (this rank's coordinates known) each rank draws the
    one-device stream leaf by leaf and keeps its slices under
    `sharding.layout_specs` (`transformer._cutter`): bit for bit its block
    of the one-device params, never holding more than one block whole."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    require_device(generator.device, device, "the generator's draws")
    cut = _cutter(mesh)
    dt = cdtype(cfg)
    params: Dict[str, Any] = cut({"embed": init_embed(generator, cfg)})
    params["enc_pos_embed"] = normal(generator, (cfg.encoder_seq, cfg.d_model), 0.02, dt)
    params["pos_embed"] = normal(generator, (cfg.max_position_embeddings, cfg.d_model), 0.02, dt)
    params["enc_blocks"] = [cut(_init_enc_block(generator, cfg))
                            for _ in range(cfg.encoder_layers)]
    params["dec_blocks"] = [cut(_init_dec_block(generator, cfg)) for _ in range(cfg.num_layers)]
    params["enc_final_norm"] = init_norm(generator, cfg)
    params["final_norm"] = init_norm(generator, cfg)
    params["lm_head"] = cut({"lm_head": init_unembed(generator, cfg)})["lm_head"]
    params["exits"] = [
        cut({"norm": init_norm(generator, cfg), "head": init_unembed(generator, cfg)})
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


def _enter_memory(params, cfg, memory):
    """The encoder memory as the decoder's cross-attention k/v projections
    read it: entered into their split once (`layers.enter_split`) where
    the kv heads are split, so its gradient is summed over the model axis
    once for every block."""
    wk = params["dec_blocks"][0]["cross_attn"]["wk"]
    return enter_split(memory, split_width(wk.shape[-2], cfg.num_kv_heads))


def _dec_block_seq(blk, cfg, x, positions, memory):
    h = apply_norm(blk["mixer_norm"], cfg, x)
    h, cache = attn.attention_prefill(blk["attn"], cfg, h, positions)
    x = x + h
    h = apply_norm(blk["cross_norm"], cfg, x)
    h, xcache = attn.attention_prefill(blk["cross_attn"], cfg, h, positions, memory=memory)
    x = x + h
    h = apply_norm(blk["ffn_norm"], cfg, x)
    return x + apply_mlp(blk["mlp"], cfg, h), cache, xcache


def _embed(params, cfg, tokens):
    dev = params["embed"]["w"].device
    tokens = as_tensor(tokens, dev).to(device=dev, dtype=torch.int64)
    b, s = tokens.shape
    x = apply_embed(params["embed"], tokens, cfg.vocab_size) + params["pos_embed"][:s][None]
    return x, _positions(b, s, dev)


def forward_train(params, cfg: ModelConfig, batch, remat: bool = True):
    """batch: {tokens (b,s), encoder_frames (b,enc_seq,d)}. Under a model
    axis every head's logits are this rank's vocab shard."""
    memory = _enter_memory(params, cfg, encode(params, cfg, batch["encoder_frames"]))
    x, positions = _embed(params, cfg, batch["tokens"])
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
    return {
        "logits": lm_logits(params, cfg, x),
        "exit_logits": [exit_logits_fn(params, cfg, i, h) for i, h in enumerate(exit_hiddens)],
        "moe_aux_loss": torch.zeros((), dtype=torch.float32, device=x.device),
    }


def forward_prefill(params, cfg: ModelConfig, batch):
    """Serving prefill: encode frames + teacher-forced decoder pass.

    Returns last-position logits, per-exit last-position logits (whole
    rows under a model axis), and the decode caches (self-attn KV +
    projected cross-attn memory; a rank's kv heads)."""
    memory = _enter_memory(params, cfg, encode(params, cfg, batch["encoder_frames"]))
    x, positions = _embed(params, cfg, batch["tokens"])
    exits = set(cfg.exit_layers)
    exit_hiddens = []
    self_caches, cross_caches = [], []
    for i, blk in enumerate(params["dec_blocks"]):
        x, cache, xcache = _dec_block_seq(blk, cfg, x, positions, memory)
        self_caches.append(cache)
        cross_caches.append(xcache)
        if i in exits:
            exit_hiddens.append(x)
    return {
        "logits": gather_vocab(lm_logits(params, cfg, x[:, -1:, :]), cfg),
        "exit_logits": [gather_vocab(exit_logits_fn(params, cfg, i, h[:, -1:, :]), cfg)
                        for i, h in enumerate(exit_hiddens)],
        "caches": {"self": self_caches, "cross": cross_caches},
    }


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Zeroed self-attn KV caches and cross-attn memory caches on `device`
    (``cuda`` by default); `registry.init_cache(mesh=)` gives a rank its
    kv heads of them."""
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
    """Encode + project cross-attn K/V once per request (serving); under a
    model axis onto this rank's kv heads."""
    memory = encode(params, cfg, frames)
    return [{"k": einsum("bsd,dhk->bshk", memory, blk["cross_attn"]["wk"]),
             "v": einsum("bsd,dhk->bshk", memory, blk["cross_attn"]["wv"])}
            for blk in params["dec_blocks"]]


def decode_step(params, cfg: ModelConfig, token, caches, pos):
    """token: (b, 1) int; pos: int. Returns (out, caches), the self caches
    updated in place. Under a model axis ``out["logits"]`` is this rank's
    vocab shard (`transformer.vocab_argmax`) and the exit logits are
    whole."""
    dev = params["embed"]["w"].device
    token = as_tensor(token, dev).to(device=dev, dtype=torch.int64)
    pos = int(pos)
    x = apply_embed(params["embed"], token, cfg.vocab_size) + params["pos_embed"][pos][None, None]
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
    ex_logits = [gather_vocab(exit_logits_fn(params, cfg, i, h), cfg)
                 for i, h in enumerate(exit_hiddens)]
    return {"logits": lm_logits(params, cfg, x), "exit_logits": ex_logits}, caches
