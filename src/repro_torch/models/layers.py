"""Basic layers: norms, MLPs, embeddings, rotary embeddings (port of
`repro.models.layers`).

Pure-functional style: ``init_*`` builds a params tree (nested dicts of
tensors) from an explicit `torch.Generator` on the device it lives on;
``apply`` functions consume it. Compute follows the reference's mixed
precision: params and matmuls in cfg.dtype (bf16), normalization and
softmax statistics in float32, each cast where the reference casts.

Mixed dtypes follow JAX's promotion: a product of a bf16 weight and a
float32 activation (the cloud partition after the codec, which decodes
to float32) runs in float32, the weight cast up for that one product
(`matmul`, `einsum`). An activation is never cast down.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def cdtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def promote(*tensors):
    """The tensors cast to their common dtype (JAX's promotion of mixed
    floating dtypes: bf16 with float32 is float32)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in tensors]


def matmul(x, w):
    """``x @ w`` in the promoted dtype."""
    x, w = promote(x, w)
    return x @ w


def einsum(spec, *operands):
    """`torch.einsum` in the promoted dtype."""
    return torch.einsum(spec, *promote(*operands))


def normal(generator, shape, scale, dtype):
    """N(0, scale^2) draws in float32, cast to `dtype` (the reference's
    ``(jax.random.normal(k, shape) * scale).astype(dt)``)."""
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (w * scale).to(dtype)


# ----------------------------------------------------------------- norms
def init_norm(generator, cfg, d=None):
    d = d or cfg.d_model
    dev = generator.device
    if cfg.norm_type == "nonparametric_ln":  # OLMo: no scale/bias
        return {}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(d, device=dev), "bias": torch.zeros(d, device=dev)}
    return {"scale": torch.ones(d, device=dev)}


def apply_norm(p, cfg, x, eps=1e-6):
    xf = x.to(torch.float32)
    if cfg.norm_type in ("layernorm", "nonparametric_ln"):
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)  # jnp.var: population
        y = (xf - mu) * torch.rsqrt(var + eps)
        if p:
            y = y * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps)
        y = y * p["scale"]
    return y.to(x.dtype)


def rms_norm_headwise(x, scale, eps=1e-6):
    """qk-norm: RMS over the head_dim of (..., head_dim)."""
    xf = x.to(torch.float32)
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# ----------------------------------------------------------------- MLP
def init_mlp(generator, cfg, d_ff=None):
    d, dt = cfg.d_model, cdtype(cfg)
    d_ff = d_ff or cfg.d_ff
    p = {
        "w_up": normal(generator, (d, d_ff), d ** -0.5, dt),
        "w_down": normal(generator, (d_ff, d), d_ff ** -0.5, dt),
    }
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = normal(generator, (d, d_ff), d ** -0.5, dt)
    return p


def apply_mlp(p, cfg, x):
    up = matmul(x, p["w_up"])
    if cfg.mlp_type == "swiglu":
        up = F.silu(matmul(x, p["w_gate"])) * up
    else:
        up = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default
    return matmul(up, p["w_down"])


# ----------------------------------------------------------------- embeddings
def init_embed(generator, cfg):
    return {"w": normal(generator, (cfg.vocab_size, cfg.d_model), 0.02, cdtype(cfg))}


def apply_embed(p, tokens):
    return p["w"][tokens]


def init_unembed(generator, cfg):
    return {"w": normal(generator, (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5,
                        cdtype(cfg))}


def apply_unembed(p, x):
    return matmul(x, p["w"])


# ----------------------------------------------------------------- rotary
def rope_freqs(cfg, positions):
    """positions: int (...,). Returns cos/sin of shape (..., head_dim//2)."""
    hd = cfg.head_dim
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=positions.device) / hd
    inv = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim//2).
    Rotates the two halves of head_dim (not interleaved pairs), in float32."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)

