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

Under a model axis (`sharding.use_mesh`, params cut by
`sharding.layout_specs`) a layer whose heads the axis divides holds its
block of the SSD heads: the z, x and dt columns of ``in_proj`` and the x
channels of ``conv_w`` / ``conv_b`` for those heads, the whole B and C
columns and channels (which feed every head), and its heads' ``A_log``,
``D``, ``dt_bias``, ``norm_scale`` channels and ``out_proj`` rows
(``dt_proj``, in the split-proj variant, whole). The block reads its
local widths from its leaves (`_dims`), scans its heads with their
groups of B and C, takes the gated RMSNorm's mean over the whole
``d_inner`` through one float32 all-reduce of each row's sum of squares,
and ``out_proj`` is row-parallel (`layers.row_parallel`). Its caches are
its heads' conv channels and SSD state. A layer whose heads the axis
does not divide is whole on every rank and runs as on one device.

Under autograd the block's input enters the split through
`layers.enter_split` (its gradient summed over the ranks, each rank's B
and C part of it counted once there). The sum of squares is
``model_grad(model_sum(ss))``: its gradient on a rank covers only that
rank's channels, so it is summed backward too. The whole B and C blocks
of ``in_proj``, ``conv_w`` and ``conv_b`` (and ``dt_proj``) get each
rank's partial gradient, so they enter through `model_grad` as well
(`_whole_cols`): every replicated element's gradient is one device's,
the same on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import model_grad, model_sum
from repro_torch.models.layers import cdtype, enter_split, matmul, normal, row_parallel, \
    split_width


def _dims(cfg, p=None):
    """(d_inner, heads, groups, state, conv kernel, conv channels) of a
    layer; with its params `p`, this rank's (its heads' d_inner and conv
    channels, read from the leaves)."""
    h = cfg.ssm_heads if p is None else p["A_log"].shape[-1]
    di = h * cfg.ssm_head_dim
    g, n, ck = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_conv
    conv_ch = di + 2 * g * n
    return di, h, g, n, ck, conv_ch


def _split(p, cfg):
    """The layer's model split (`layers.split_width`) of its SSD heads:
    None where it is whole."""
    return split_width(p["A_log"].shape[-1], cfg.ssm_heads)


def _groups(cfg, split, h, device):
    """The B/C group of each of this rank's `h` heads (None: every head,
    `ssd_chunked`'s repeat)."""
    if split is None:
        return None
    heads = split[1] * h + torch.arange(h, device=device)
    return heads // (cfg.ssm_heads // cfg.ssm_n_groups)


def _by_head(t, dim, hg, groups):
    """`t`'s groups along `dim` for each head: every head's (hg a group)
    or, given `groups`, the listed ones."""
    if groups is None:
        return torch.repeat_interleave(t, hg, dim=dim)
    return t.index_select(dim, groups)


def _whole_cols(w, lo, hi, split):
    """`w` with its last dim's columns lo:hi, whole on every rank of
    `split`, entering through `model_grad` (each rank's gradient of them
    is partial); `w` as it is without a split or a gradient."""
    if split is None or not (torch.is_grad_enabled() and w.requires_grad):
        return w
    return torch.cat([w[..., :lo], model_grad(w[..., lo:hi], split[0]), w[..., hi:]], dim=-1)


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


def _project_in(p, cfg, x, split=None):
    """x @ in_proj -> (z, xbc, dt_raw), handling the split-proj variant;
    this rank's heads' columns under `split`."""
    di, h, g, n, _, _ = _dims(cfg, p)
    w = _whole_cols(p["in_proj"], 2 * di, 2 * di + 2 * g * n, split)
    if cfg.mamba_split_proj:
        z, xbc = torch.split(matmul(x, w), [di, 2 * g * n + di], dim=-1)
        dt_w = p["dt_proj"]
        if split is not None:  # whole: this rank's heads' columns
            dt_w = enter_split(dt_w, split)[:, split[1] * h:(split[1] + 1) * h]
        return z, xbc, matmul(x, dt_w)
    return torch.split(matmul(x, w), [di, di + 2 * g * n, h], dim=-1)


def _conv_params(p, cfg, split):
    """(conv_w, conv_b), their whole B/C channels entering the split."""
    di, _, g, n, _, _ = _dims(cfg, p)
    return (_whole_cols(p["conv_w"], di, di + 2 * g * n, split),
            _whole_cols(p["conv_b"], di, di + 2 * g * n, split))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _gated_out(p, cfg, y, z, split=None):
    """Gated RMSNorm, norm(y * silu(z)) * scale, then out_proj; under
    `split` the mean over the whole d_inner from the ranks' float32 sums
    of squares, and out_proj row-parallel."""
    yz = (y * F.silu(z.to(torch.float32))).to(torch.float32)
    if split is None:
        ms = torch.mean(torch.square(yz), dim=-1, keepdim=True)
    else:
        ss = torch.sum(torch.square(yz), dim=-1, keepdim=True)
        ms = model_grad(model_sum(ss, split[0]), split[0]) / cfg.d_inner
    yn = yz * torch.rsqrt(ms + 1e-6) * p["norm_scale"]
    return row_parallel(yn.to(cdtype(cfg)), p["out_proj"], cfg.d_inner)


def ssd_chunked(x, dt, A, B, C, D, chunk, groups=None):
    """SSD scan. x:(b,s,h,p) dt:(b,s,h) A:(h,) B,C:(b,s,g,n) D:(h,).
    `groups`: the B/C group of each of the h heads, where they are some
    of the layer's (a rank's under a model axis); None: h is every head,
    h / g a group.

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
    cb = _by_head(cb, 2, hg, groups)  # (b,nc,h,l,l)
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
    Bh = _by_head(Bc, 3, hg, groups)  # (b,nc,l,h,n)
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
    Ch = _by_head(Cc, 3, hg, groups)  # (b,nc,l,h,n)
    y_off = torch.einsum("bclhn,bchpn->bclhp", Ch, S_prev) * torch.exp(-dA_cs)[..., None]

    y = (y_diag + y_off).reshape(b, s, h, ph)
    y = y + xf * D[None, None, :, None]
    return y, S


def mamba_prefill(p, cfg, x):
    """x: (b, s, d) -> (out (b,s,d), cache{conv, ssd}); under a model
    split, the cache of this rank's heads."""
    b, s, d = x.shape
    di, h, g, n, ck, conv_ch = _dims(cfg, p)
    split = _split(p, cfg)
    x = enter_split(x, split)
    z, xbc, dt_raw = _project_in(p, cfg, x, split)
    conv_w, conv_b = _conv_params(p, cfg, split)

    # causal depthwise conv, kernel ck: the reference's sum of shifted
    # products, in its order
    xbc_pad = torch.cat([xbc.new_zeros((b, ck - 1, conv_ch)), xbc], dim=1)
    conv = sum(xbc_pad[:, i:i + s, :] * conv_w[i][None, None, :] for i in range(ck))
    xbc_c = F.silu((conv + conv_b).to(torch.float32)).to(xbc.dtype)

    xs, B, C = torch.split(xbc_c, [di, g * n, g * n], dim=-1)
    xs = xs.reshape(b, s, h, cfg.ssm_head_dim)
    B = B.reshape(b, s, g, n)
    C = C.reshape(b, s, g, n)
    A = torch.exp(p["A_log"])  # (h,) positive
    dtv = _softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # (b,s,h)

    chunk = min(cfg.ssm_chunk, s)
    if s % chunk != 0:
        chunk = s  # a single chunk for odd smoke shapes
    y, S = ssd_chunked(xs, dtv, A, B, C, p["D"], chunk, _groups(cfg, split, h, x.device))
    out = _gated_out(p, cfg, y.reshape(b, s, di).to(cdtype(cfg)), z, split)
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
    (this rank's heads' under a model split) updated in place."""
    b = x.shape[0]
    di, h, g, n, ck, conv_ch = _dims(cfg, p)
    split = _split(p, cfg)
    x = enter_split(x, split)
    z, xbc, dt_raw = _project_in(p, cfg, x[:, 0, :], split)
    conv_w, conv_b = _conv_params(p, cfg, split)

    conv_buf = torch.cat([cache["conv"], xbc[:, None, :].to(cache["conv"].dtype)], dim=1)
    conv = torch.einsum("bkc,kc->bc", conv_buf, conv_w) + conv_b
    xbc_c = F.silu(conv.to(torch.float32)).to(xbc.dtype)

    xs, B, C = torch.split(xbc_c, [di, g * n, g * n], dim=-1)
    xs = xs.reshape(b, h, cfg.ssm_head_dim).to(torch.float32)
    hg, groups = h // g, _groups(cfg, split, h, x.device)
    Bh = _by_head(B.reshape(b, g, n).to(torch.float32), 1, hg, groups)  # (b,h,n)
    Ch = _by_head(C.reshape(b, g, n).to(torch.float32), 1, hg, groups)
    A = torch.exp(p["A_log"])
    dtv = _softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # (b,h)

    decay = torch.exp(-dtv * A)  # (b,h)
    S = cache["ssd"] * decay[:, :, None, None] + torch.einsum("bh,bhn,bhp->bhpn", dtv, Bh, xs)
    y = torch.einsum("bhn,bhpn->bhp", Ch, S) + xs * p["D"][None, :, None]
    out = _gated_out(p, cfg, y.reshape(b, 1, di).to(cdtype(cfg)), z[:, None, :], split)
    cache["conv"].copy_(conv_buf[:, 1:, :])
    cache["ssd"].copy_(S)
    return out, cache
