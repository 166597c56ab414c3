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

Under a model axis (`sharding.use_mesh`, params from
`sharding.local_shards`), Megatron-style: a leaf the specs split holds
this rank's block of its split dim, and the global width in the config
tells a split leaf from a whole one. The embedding is vocab-parallel
(`apply_embed`: this rank's rows, zeros for the other ids, one exact
all-reduce); the products into a split width (``w_gate``/``w_up``, the
q/k/v heads, the unembedding's vocab) are column-parallel and need no
collective; the products out of one (``w_down``, ``wo``) are
row-parallel: `reduce_partial` sums each rank's float32 partial over the
model axis and rounds once to the activation dtype, so a bf16 result
differs from one device's only by the order of float32 sums.

Under autograd every collective goes through `launch.mesh`'s functions
of the model axis: the embedding's and the row-parallel sums are
`model_sum` (the gradient passes through), and a replicated activation
entering a column-parallel product goes through `enter_split`
(`model_grad`: its gradient, partial on each rank, is summed over the
axis), so every replicated leaf gets one device's whole gradient on
every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import model_grad, model_sum
from repro_torch.sharding import model_split

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


# ----------------------------------------------------- tensor parallelism
def split_width(local: int, width: int):
    """The model split of a leaf dim whose global size is `width` and
    this rank's is `local`: (process group, index, ranks) when the specs
    cut it, else None (no model axis, or the dim is whole)."""
    tp = model_split()
    if tp is None or local == width:
        return None
    if local * tp[2] != width:
        raise ValueError(f"a local width of {local} is no block of {width} over {tp[2]} ranks")
    return tp


def enter_split(x, split):
    """`x` as the input of a product into a width `split` cuts (its
    gradient summed over the model ranks), or as it is when `split` is
    None."""
    return x if split is None else model_grad(x, split[0])


class _WideMM(torch.autograd.Function):
    """``x @ w`` of 2-D bf16 operands in one GEMM with a float32 output
    (`torch.mm(..., out_dtype=)`, which has no derivative of its own).
    Backward as one device's bf16 product: the output gradient, which
    reaches a partial only through its rounding to bf16 and so is exact in
    bf16, times the other operand, in bf16."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return (g @ w.T if ctx.needs_input_grad[0] else None,
                x.T @ g if ctx.needs_input_grad[1] else None)


def partial_product(x, w):
    """``x @ w`` for a 2-D `w`, its sum accumulated and returned in
    float32 (a row-parallel partial, reduced by `reduce_partial`). On the
    card bf16 operands go through one GEMM with a float32 output
    (`_WideMM`); elsewhere they are cast up, which is the same sum (a
    product of two bf16 values is exact in float32)."""
    x, w = promote(x, w)
    if x.dtype != torch.float32 and x.is_cuda:
        y = _WideMM.apply(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(x.shape[:-1] + (w.shape[1],))
    return x.to(torch.float32) @ w.to(torch.float32)


def reduce_partial(y, split, dtype):
    """Sum a float32 partial over the model ranks of `split` and round it
    once to `dtype`."""
    return model_sum(y.contiguous(), split[0]).to(dtype)


def row_parallel(x, w, width: int):
    """``x @ w`` where the first dim of `w` (of global size `width`) may be
    split over the model axis: the one-device product when it is whole,
    else the reduced float32 partials."""
    split = split_width(w.shape[0], width)
    if split is None:
        return matmul(x, w)
    return reduce_partial(partial_product(x, w), split, torch.promote_types(x.dtype, w.dtype))


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
    x = enter_split(x, split_width(p["w_up"].shape[-1], cfg.d_ff))
    up = matmul(x, p["w_up"])
    if cfg.mlp_type == "swiglu":
        up = F.silu(matmul(x, p["w_gate"])) * up
    else:
        up = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default
    return row_parallel(up, p["w_down"], cfg.d_ff)


# ----------------------------------------------------------------- embeddings
def init_embed(generator, cfg):
    return {"w": normal(generator, (cfg.vocab_size, cfg.d_model), 0.02, cdtype(cfg))}


def apply_embed(p, tokens, vocab=None):
    """Rows of the embedding for `tokens`. With its vocab split over the
    model axis (global size `vocab`), each rank looks up the ids in its
    block and zeros the others, and one all-reduce adds the blocks: exact,
    since each row is one rank's row plus zeros."""
    split = None if vocab is None else split_width(p["w"].shape[0], vocab)
    if split is None:
        return p["w"][tokens]
    n = p["w"].shape[0]
    local = tokens - split[1] * n
    mine = (local >= 0) & (local < n)
    x = p["w"][torch.where(mine, local, 0)] * mine[..., None].to(p["w"].dtype)
    return model_sum(x, split[0])


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

