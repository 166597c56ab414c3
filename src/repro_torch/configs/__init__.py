"""Config registry (port of `repro.configs`): ``get_config(arch_id)`` /
``get_smoke(arch_id)``.

Every assigned architecture has a module here exporting CONFIG and SMOKE,
including the families whose models the port cannot run yet.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    ModelConfig,
    ShapeConfig,
    smoke_variant,
)

ARCHS = [
    "mamba2_130m",
    "granite_moe_3b_a800m",
    "chameleon_34b",
    "olmo_1b",
    "qwen3_8b",
    "qwen3_moe_30b_a3b",
    "internlm2_20b",
    "jamba_v01_52b",
    "whisper_base",
    "qwen2_72b",
    "b_alexnet",  # the paper's own architecture
]

# Assigned ids use dashes; module names use underscores.
_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update(
    {
        "mamba2-130m": "mamba2_130m",
        "granite-moe-3b-a800m": "granite_moe_3b_a800m",
        "chameleon-34b": "chameleon_34b",
        "olmo-1b": "olmo_1b",
        "qwen3-8b": "qwen3_8b",
        "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
        "internlm2-20b": "internlm2_20b",
        "jamba-v0.1-52b": "jamba_v01_52b",
        "whisper-base": "whisper_base",
        "qwen2-72b": "qwen2_72b",
        "b-alexnet": "b_alexnet",
    }
)


def _module(arch: str):
    mod_name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", ""))
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def list_archs():
    return list(ARCHS)
