"""Model registry: one uniform API over the zoo (port of
`repro.models.registry`).

Dispatches on cfg.family:
  * convnet            -> repro_torch.models.convnet   (the paper's B-AlexNet)
  * audio (enc-dec)    -> repro_torch.models.whisper
  * everything else    -> repro_torch.models.transformer

Also provides the dry run's stand-ins (`input_specs`, `cache_specs`,
`param_specs_shapes`): trees of ``meta`` tensors, with the reference's keys
and nesting, that carry a shape and a dtype and allocate nothing.
`launch.dryrun` traces each step against fake tensors made from them.
"""
from __future__ import annotations

import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import sharding
from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import convnet, transformer, whisper
from repro_torch.models.layers import DTYPES


def _mod(cfg: ModelConfig):
    if cfg.family == "audio" or cfg.is_encoder_decoder:
        return whisper
    return transformer


def init_params(generator, cfg: ModelConfig, device=None, mesh=None):
    """Seeded params on `device` (``cuda`` by default) from `generator`
    (on that device; None seeds a fresh one with 0). With `mesh`, this
    rank's slices (`transformer.init_params`, `whisper.init_params`); the
    convnet's layout keeps every leaf whole, so its params are one
    device's on every rank."""
    if cfg.family == "convnet":
        return convnet.init_params(generator, device=device, cfg=cfg)
    return _mod(cfg).init_params(generator, cfg, device=device, mesh=mesh)


def forward_train(params, cfg: ModelConfig, batch, remat: bool = True):
    if cfg.family == "convnet":
        return convnet.forward(params, batch["images"])
    return _mod(cfg).forward_train(params, cfg, batch, remat=remat)


def forward_prefill(params, cfg: ModelConfig, batch):
    return _mod(cfg).forward_prefill(params, cfg, batch)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None, mesh=None):
    """Zeroed decode caches; with `mesh`, only this rank's part of them,
    as `sharding.cache_layout` lays them out (batch rows over the data
    axes where they divide the batch, kv heads and SSD heads over the
    model axis where it divides them, a conv buffer's x channels with its
    SSD heads and its B and C channels whole)."""
    if mesh is None:
        return _mod(cfg).init_cache(cfg, batch, seq_len, device=device)
    whole = _mod(cfg).init_cache(cfg, batch, seq_len, device="meta")
    return sharding.local_zeros(whole, sharding.cache_layout(whole, mesh), mesh,
                                resolve_device(device))


def decode_step(params, cfg: ModelConfig, token, caches, pos):
    return _mod(cfg).decode_step(params, cfg, token, caches, pos)


# ----------------------------------------------------------------- input specs
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Meta tensors for the inputs of the step the shape exercises.

    train  -> {tokens, labels[, encoder_frames]}
    prefill-> {tokens[, encoder_frames]}
    decode -> {token (b,1), pos scalar} (+cache specs via cache_specs()).
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family == "convnet":
        return {"images": _meta((b, 32, 32, 3), torch.float32), "labels": _meta((b,), i32)}
    if shape.kind == "train":
        out = {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}
    elif shape.kind == "prefill":
        out = {"tokens": _meta((b, s), i32)}
    else:  # decode
        out = {"token": _meta((b, 1), i32), "pos": _meta((), i32)}
    if cfg.is_encoder_decoder and shape.kind != "decode":
        out["encoder_frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), DTYPES[cfg.dtype])
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Meta tensors for the decode cache (no allocation)."""
    return init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")


def param_specs_shapes(cfg: ModelConfig):
    """Meta tensors for the parameters: the seeded init runs on fake CPU
    tensors (no allocation), and each leaf keeps its shape and dtype."""
    with FakeTensorMode(allow_fallback_kernels=False):
        params = init_params(None, cfg, device="cpu")
    return pytree.tree_map(lambda t: _meta(t.shape, t.dtype), params)
