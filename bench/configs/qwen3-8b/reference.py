"""The plain reference of Qwen3 at prefill: float32 PyTorch operations on
the benchmark's weights (bf16 leaves cast up), with nothing of the port.

Per layer: RMSNorm; q, k, v projections; RMSNorm of each q and k head
(qk-norm); RoPE (the two halves of a head rotated, positions 0..s-1);
causal grouped-query attention (q head h reads kv head h // (qh / kvh));
the output projection and the residual; RMSNorm; the SwiGLU MLP and the
residual. The exit after layer ``exit_layer`` and the final head read the
last position through their RMSNorm.

`forward` walks the layers one at a time over all the rows it is given,
in blocks of rows, so that one layer's weights are cast up once and a
block's attention scores fit. With ``precision`` other than float32 every
product's operands are rounded first (the control, `benchkit.precision`).
"""
from __future__ import annotations

import torch

from benchkit.precision import round_to

BLOCK_TOKENS = 16384
LAYER_KEYS = ("mixer_norm", "wq", "wk", "wv", "wo", "q_norm", "k_norm", "ffn_norm",
              "w_gate", "w_up", "w_down")


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def _rope(x, cos, sin):
    """x (r, s, h, hd); cos, sin (s, hd/2)."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _layer(x, w, spec, cos, sin, r):
    """One decoder layer on x (r, s, d) float32; w holds this layer's float32 leaves."""
    eps = spec["rms_norm_eps"]
    rows, s, d = x.shape
    qh, kvh, hd = spec["num_attention_heads"], spec["num_key_value_heads"], spec["head_dim"]
    g = qh // kvh
    h = r(_rms(x, w["mixer_norm"], eps).reshape(rows * s, d))
    q = (h @ r(w["wq"].reshape(d, qh * hd))).reshape(rows, s, qh, hd)
    k = (h @ r(w["wk"].reshape(d, kvh * hd))).reshape(rows, s, kvh, hd)
    v = (h @ r(w["wv"].reshape(d, kvh * hd))).reshape(rows, s, kvh, hd)
    q = _rope(_rms(q, w["q_norm"], eps), cos, sin)
    k = _rope(_rms(k, w["k_norm"], eps), cos, sin)
    q = q.reshape(rows, s, kvh, g, hd).permute(0, 2, 3, 1, 4)  # (r, kvh, g, s, hd)
    k = k.permute(0, 2, 1, 3)[:, :, None]  # (r, kvh, 1, s, hd)
    v = v.permute(0, 2, 1, 3)[:, :, None]
    scores = (r(q) @ r(k).transpose(-1, -2)) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(causal, float("-inf")), dim=-1)
    o = (r(probs) @ r(v)).permute(0, 3, 1, 2, 4).reshape(rows * s, qh * hd)
    x = x + (r(o) @ r(w["wo"].reshape(qh * hd, d))).reshape(rows, s, d)
    h = r(_rms(x, w["ffn_norm"], eps).reshape(rows * s, d))
    a = torch.nn.functional.silu(h @ r(w["w_gate"])) * (h @ r(w["w_up"]))
    return x + (r(a) @ r(w["w_down"])).reshape(rows, s, d)


def _head(x_last, scale, w, spec, r):
    return r(_rms(x_last, scale, spec["rms_norm_eps"])) @ r(w.float())


def forward(weights, spec, inputs, final, precision="float32"):
    """(exit logits (n, V), final logits (final.sum(), V)), float32, at the
    last position of each of the n sequences of ``inputs["tokens"]``."""
    def r(x):
        return round_to(x, precision)

    tokens = inputs["tokens"]
    n, s = tokens.shape
    hd, dev = spec["head_dim"], tokens.device
    inv = float(spec["rope_theta"]) ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                                       device=dev) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=dev)[:, None] * inv
    cos, sin = ang.cos().float(), ang.sin().float()
    block = max(1, BLOCK_TOKENS // s)
    with torch.no_grad():
        x = weights["embed"][tokens].float()
        exit_logits = None
        for layer in range(spec["num_hidden_layers"]):
            w = {k: weights[k][layer].float() for k in LAYER_KEYS}
            x = torch.cat([_layer(x[i:i + block], w, spec, cos, sin, r)
                           for i in range(0, x.shape[0], block)])
            if layer == spec["exit_layer"]:
                exit_logits = _head(x[:, -1], weights["exit_norm"], weights["exit_head"], spec, r)
                x = x[final]
                if not len(x):
                    return exit_logits, exit_logits[:0]
        final_logits = _head(x[:, -1], weights["final_norm"], weights["lm_head"], spec, r)
    return exit_logits, final_logits
