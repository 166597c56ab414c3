"""Model registry: one uniform API over the zoo (port of
`repro.models.registry`).

Dispatches on cfg.family:
  * convnet            -> repro_torch.models.convnet   (the paper's B-AlexNet)
  * audio (enc-dec)    -> repro_torch.models.whisper
  * everything else    -> repro_torch.models.transformer

The reference's dry-run helpers (`input_specs`, `cache_specs`,
`param_specs_shapes`) come with the dry-run tooling (ROADMAP.md queue 1
item 7e).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import convnet, transformer, whisper


def _mod(cfg: ModelConfig):
    if cfg.family == "audio" or cfg.is_encoder_decoder:
        return whisper
    return transformer


def init_params(generator, cfg: ModelConfig, device=None):
    """Seeded params on `device` (``cuda`` by default) from `generator`
    (on that device; None seeds a fresh one with 0)."""
    if cfg.family == "convnet":
        return convnet.init_params(generator, device=device, cfg=cfg)
    return _mod(cfg).init_params(generator, cfg, device=device)


def forward_train(params, cfg: ModelConfig, batch, remat: bool = True):
    if cfg.family == "convnet":
        return convnet.forward(params, batch["images"])
    return _mod(cfg).forward_train(params, cfg, batch, remat=remat)


def forward_prefill(params, cfg: ModelConfig, batch):
    return _mod(cfg).forward_prefill(params, cfg, batch)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    return _mod(cfg).init_cache(cfg, batch, seq_len, device=device)


def decode_step(params, cfg: ModelConfig, token, caches, pos):
    return _mod(cfg).decode_step(params, cfg, token, caches, pos)
