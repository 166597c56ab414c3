"""Mamba2 (state-space duality / SSD) block (port of
`repro.models.mamba`).

The chunked SSD algorithm of Dao & Gu (arXiv:2405.21060):
  * in_proj -> [z, x, B, C, dt]; causal depthwise conv over (x, B, C);
  * intra-chunk "attention-like" quadratic term + inter-chunk linear
    recurrence over per-chunk states (the duality), the recurrence a
    Python loop over the s / chunk chunks;
  * gated RMSNorm and out_proj.

Decode keeps O(1) state per layer: a (conv_k-1)-step conv buffer and the
(heads, head_dim, state) SSD state, both updated IN PLACE (as the
attention caches are), so a layer's view of a stacked cache writes
through to the stack.

One difference from the reference, in the backward pass only: the
intra-chunk decay masks its argument with -inf above the diagonal before
the ``exp`` (the reference takes ``where(causal, exp(-seg), 0)``). The
forward values are the same; the reference's form overflows to inf above
the diagonal once dt grows, and 0 * inf is NaN in the gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import cdtype, matmul, normal


def _dims(cfg):
    di = cfg.d_inner
    h = cfg.ssm_heads
    g, n, ck = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_conv
    conv_ch = di + 2 * g * n
    return di, h, g, n, ck, conv_ch


def init_mamba(generator, cfg):
    d = cfg.d_model
    di, h, g, n, ck, conv_ch = _dims(cfg)
    dt = cdtype(cfg)
    dev = generator.device
    if cfg.mamba_split_proj:
        # dt kept out of in_proj (the reference's tensor-parallel layout)
        p = {
            "in_proj": normal(generator, (d, 2 * di + 2 * g * n), d ** -0.5, dt),
            "dt_proj": normal(generator, (d, h), d ** -0.5, dt),
        }
    else:
        p = {"in_proj": normal(generator, (d, 2 * di + 2 * g * n + h), d ** -0.5, dt)}
    p.update({
        "conv_w": normal(generator, (ck, conv_ch), ck ** -0.5, dt),
        "conv_b": torch.zeros(conv_ch, dtype=dt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "D": torch.ones(h, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.full((h,), 0.01, device=dev))),
        "norm_scale": torch.ones(di, device=dev),
        "out_proj": normal(generator, (di, d), di ** -0.5, dt),
    })
    return p


def _project_in(p, cfg, x):
    """x @ in_proj -> (z, xbc, dt_raw), handling the split-proj variant."""
    di, h, g, n, _, _ = _dims(cfg)
    if cfg.mamba_split_proj:
        z, xbc = torch.split(matmul(x, p["in_proj"]), [di, 2 * g * n + di], dim=-1)
        return z, xbc, matmul(x, p["dt_proj"])
    return torch.split(matmul(x, p["in_proj"]), [di, di + 2 * g * n, h], dim=-1)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _gated_out(p, cfg, y, z):
    # gated RMSNorm: norm(y * silu(z)) * scale
    yz = (y * F.silu(z.to(torch.float32))).to(torch.float32)
    ms = torch.mean(torch.square(yz), dim=-1, keepdim=True)
    yn = yz * torch.rsqrt(ms + 1e-6) * p["norm_scale"]
    return matmul(yn.to(cdtype(cfg)), p["out_proj"])


def ssd_chunked(x, dt, A, B, C, D, chunk):
    """SSD scan. x:(b,s,h,p) dt:(b,s,h) A:(h,) B,C:(b,s,g,n) D:(h,).

    Returns y:(b,s,h,p) fp32 and the final state (b,h,p,n).
    """
    b, s, h, ph = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g  # heads per B/C group
    nc = s // chunk
    xf = x.to(torch.float32)
    xc = xf.reshape(b, nc, chunk, h, ph)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.to(torch.float32).reshape(b, nc, chunk, g, n)
    Cc = C.to(torch.float32).reshape(b, nc, chunk, g, n)

    dA = dtc * A  # (b,nc,l,h), positive decay rates (A = exp(A_log) > 0)
    dA_cs = torch.cumsum(dA, dim=2)  # inclusive cumsum

    # ---- intra-chunk (quadratic) term ------------------------------------
    # CB[i,j] per group, decay exp(-(cs_i - cs_j)) for i>=j, weight dt_j
    cb = torch.einsum("bclgn,bcmgn->bcglm", Cc, Bc)  # (b,nc,g,l,l)
    cb = torch.repeat_interleave(cb, hg, dim=2)  # (b,nc,h,l,l)
    seg = dA_cs[..., :, None, :] - dA_cs[..., None, :, :]  # (b,nc,l,l,h) = cs_i-cs_j
    seg = torch.movedim(seg, -1, 2)  # (b,nc,h,l,l)
    li = torch.arange(chunk, device=x.device)
    causal = li[:, None] >= li[None, :]
    decay = torch.exp(torch.where(causal, -seg, -torch.inf))  # masked before the exp
    att = cb * decay * torch.movedim(dtc, -1, 2)[..., None, :]  # * dt_j
    y_diag = torch.einsum("bchlm,bcmhp->bclhp", att, xc)

    # ---- per-chunk input states ------------------------------------------
    # S_c = sum_j exp(-(cs_last - cs_j)) * dt_j * B_j (x) x_j
    w = torch.exp(-(dA_cs[:, :, -1:, :] - dA_cs)) * dtc  # (b,nc,l,h)
    Bh = torch.repeat_interleave(Bc, hg, dim=3)  # (b,nc,l,h,n)
    S_in = torch.einsum("bclh,bclhn,bclhp->bchpn", w, Bh, xc)

    # ---- inter-chunk recurrence over chunk states -------------------------
    chunk_decay = torch.exp(-dA_cs[:, :, -1, :])  # (b,nc,h)
    S = xf.new_zeros((b, h, ph, n))
    S_prev = []  # the state entering each chunk
    for c in range(nc):
        S_prev.append(S)
        S = S * chunk_decay[:, c, :, None, None] + S_in[:, c]
    S_prev = torch.stack(S_prev, dim=1)  # (b,nc,h,p,n)

    # ---- inter-chunk output: C_i . S_prev with decay exp(-cs_i) -----------
    Ch = torch.repeat_interleave(Cc, hg, dim=3)  # (b,nc,l,h,n)
    y_off = torch.einsum("bclhn,bchpn->bclhp", Ch, S_prev) * torch.exp(-dA_cs)[..., None]

    y = (y_diag + y_off).reshape(b, s, h, ph)
    y = y + xf * D[None, None, :, None]
    return y, S


def mamba_prefill(p, cfg, x):
    """x: (b, s, d) -> (out (b,s,d), cache{conv, ssd})."""
    b, s, d = x.shape
    di, h, g, n, ck, conv_ch = _dims(cfg)
    z, xbc, dt_raw = _project_in(p, cfg, x)

    # causal depthwise conv, kernel ck: the reference's sum of shifted
    # products, in its order
    xbc_pad = torch.cat([xbc.new_zeros((b, ck - 1, conv_ch)), xbc], dim=1)
    conv = sum(xbc_pad[:, i:i + s, :] * p["conv_w"][i][None, None, :] for i in range(ck))
    xbc_c = F.silu((conv + p["conv_b"]).to(torch.float32)).to(xbc.dtype)

    xs, B, C = torch.split(xbc_c, [di, g * n, g * n], dim=-1)
    xs = xs.reshape(b, s, h, cfg.ssm_head_dim)
    B = B.reshape(b, s, g, n)
    C = C.reshape(b, s, g, n)
    A = torch.exp(p["A_log"])  # (h,) positive
    dtv = _softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # (b,s,h)

    chunk = min(cfg.ssm_chunk, s)
    if s % chunk != 0:
        chunk = s  # a single chunk for odd smoke shapes
    y, S = ssd_chunked(xs, dtv, A, B, C, p["D"], chunk)
    out = _gated_out(p, cfg, y.reshape(b, s, di).to(cdtype(cfg)), z)
    cache = {"conv": xbc_pad[:, s:, :], "ssd": S}  # the last ck-1 inputs
    return out, cache


def init_mamba_cache(cfg, batch, device):
    di, h, g, n, ck, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((batch, ck - 1, conv_ch), dtype=cdtype(cfg), device=device),
        "ssd": torch.zeros((batch, h, cfg.ssm_head_dim, n), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(p, cfg, x, cache):
    """One-token step. x: (b, 1, d) -> (out (b,1,d), cache), the cache
    updated in place."""
    b = x.shape[0]
    di, h, g, n, ck, conv_ch = _dims(cfg)
    z, xbc, dt_raw = _project_in(p, cfg, x[:, 0, :])

    conv_buf = torch.cat([cache["conv"], xbc[:, None, :].to(cache["conv"].dtype)], dim=1)
    conv = torch.einsum("bkc,kc->bc", conv_buf, p["conv_w"]) + p["conv_b"]
    xbc_c = F.silu(conv.to(torch.float32)).to(xbc.dtype)

    xs, B, C = torch.split(xbc_c, [di, g * n, g * n], dim=-1)
    xs = xs.reshape(b, h, cfg.ssm_head_dim).to(torch.float32)
    hg = h // g
    Bh = torch.repeat_interleave(B.reshape(b, g, n).to(torch.float32), hg, dim=1)  # (b,h,n)
    Ch = torch.repeat_interleave(C.reshape(b, g, n).to(torch.float32), hg, dim=1)
    A = torch.exp(p["A_log"])
    dtv = _softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # (b,h)

    decay = torch.exp(-dtv * A)  # (b,h)
    S = cache["ssd"] * decay[:, :, None, None] + torch.einsum("bh,bhn,bhp->bhpn", dtv, Bh, xs)
    y = torch.einsum("bhn,bhpn->bhp", Ch, S) + xs * p["D"][None, :, None]
    out = _gated_out(p, cfg, y.reshape(b, 1, di).to(cdtype(cfg)), z[:, None, :])
    cache["conv"].copy_(conv_buf[:, 1:, :])
    cache["ssd"].copy_(S)
    return out, cache
