"""Qwen3-8B under the benchmark: its bf16 weights and token ids made on the
card from the seed, and the port's engine over them (`lm_engine`, split
at exit `exit_index`: the edge runs the layers up to that exit and its
head, the cloud the rest and the final head on the refused rows).

The weights are the benchmark's, in a plain layout (every layer's leaf
stacked over all layers): one bf16 draw for the projections and heads and
one float32 draw for the norm scales, each leaf a view scaled to its
distribution. The port's params tree is made of views of the same storage
(its segments are slices of the stacks), so nothing is copied; the plain
reference (`reference.py`) reads the plain layout.
"""
from __future__ import annotations

import torch

#: bytes of one exit logit as the gate (K1) reads it (the head's bf16 output)
LOGIT_BYTES = 2

#: rows the reference takes in one call of the check
CHECK_ROWS = 256
#: elements per draw of the weights
CHUNK = 1 << 30


def spec(config: dict, smoke: bool = False) -> dict:
    out = dict(config)
    out.update(config.get("smoke", {}) if smoke else {})
    out["exit_layer"] = out["exit_layers"][out["exit_index"]]
    return out


def _leaves(s):
    """(name, shape, dtype, init) of every weight the split reads; init is
    ("normal", std) or ("norm", None) for an RMSNorm scale."""
    d, L, ff, v = s["hidden_size"], s["num_hidden_layers"], s["intermediate_size"], s["vocab_size"]
    qh, kvh, hd = s["num_attention_heads"], s["num_key_value_heads"], s["head_dim"]
    bf, f32 = torch.bfloat16, torch.float32
    norm = ("norm", None)
    return [
        ("embed", (v, d), bf, ("normal", s["init"]["embed_std"])),
        ("mixer_norm", (L, d), f32, norm),
        ("wq", (L, d, qh, hd), bf, ("normal", d ** -0.5)),
        ("wk", (L, d, kvh, hd), bf, ("normal", d ** -0.5)),
        ("wv", (L, d, kvh, hd), bf, ("normal", d ** -0.5)),
        ("wo", (L, qh, hd, d), bf, ("normal", (qh * hd) ** -0.5)),
        ("q_norm", (L, hd), f32, norm),
        ("k_norm", (L, hd), f32, norm),
        ("ffn_norm", (L, d), f32, norm),
        ("w_gate", (L, d, ff), bf, ("normal", d ** -0.5)),
        ("w_up", (L, d, ff), bf, ("normal", d ** -0.5)),
        ("w_down", (L, ff, d), bf, ("normal", ff ** -0.5)),
        ("exit_norm", (d,), f32, norm),
        ("exit_head", (d, v), bf, ("normal", d ** -0.5)),
        ("final_norm", (d,), f32, norm),
        ("lm_head", (d, v), bf, ("normal", d ** -0.5)),
    ]


def make_weights(gen: torch.Generator, spec: dict, device) -> dict:
    leaves = _leaves(spec)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        mine = [leaf for leaf in leaves if leaf[2] == dtype]
        sizes = [torch.Size(shape).numel() for _, shape, _, _ in mine]
        flat = torch.empty(sum(sizes), dtype=dtype, device=device)
        for i in range(0, flat.numel(), CHUNK):
            flat[i:i + CHUNK].normal_(generator=gen)
        for (name, shape, _, (kind, std)), w in zip(mine, torch.split(flat, sizes)):
            w = w.view(shape)
            out[name] = w.mul_(0.1).add_(1.0) if kind == "norm" else w.mul_(std)
    return out


def make_data(gen: torch.Generator, spec: dict, device):
    return None


def draw(state, gen: torch.Generator, n: int, workload: dict, spec: dict) -> dict:
    """n sequences of `seq_len` token ids, uniform over the vocabulary."""
    return {"tokens": torch.randint(0, spec["vocab_size"], (n, workload["seq_len"]),
                                    generator=gen, device=gen.device)}


def plan_index(spec: dict) -> int:
    """The plan's calibrator index of the deployed exit."""
    return spec["exit_index"]


def rows(inputs: dict, index) -> dict:
    return {"tokens": inputs["tokens"][index]}


def port_config(spec: dict):
    """The port's `ModelConfig` with the configuration's numbers."""
    from repro_torch.configs import get_config

    base = get_config(spec["port_config"])
    cfg = base.replace(
        num_layers=spec["num_hidden_layers"], d_model=spec["hidden_size"],
        num_heads=spec["num_attention_heads"], num_kv_heads=spec["num_key_value_heads"],
        head_dim=spec["head_dim"], d_ff=spec["intermediate_size"],
        vocab_size=spec["vocab_size"], rope_theta=float(spec["rope_theta"]),
        exit_layers=tuple(spec["exit_layers"]), exit_loss_weights=(), dtype=spec["dtype"])
    fixed = dict(family="dense", qk_norm=True, qkv_bias=False, norm_type="rmsnorm",
                 mlp_type="swiglu", tie_embeddings=False, sliding_window=0, use_rope=True)
    wrong = {k: getattr(cfg, k) for k, v in fixed.items() if getattr(cfg, k) != v}
    if wrong:
        raise ValueError(f"the port's {spec['port_config']} is not a Qwen3 block: {wrong}")
    return cfg


def port_params(weights: dict, cfg) -> dict:
    """The port's params tree as views of the benchmark's weights."""
    from repro_torch.models.transformer import segment_plan

    segments, start = [], 0
    for _, n, _ in segment_plan(cfg):
        def take(name):
            return weights[name][start] if n == 1 else weights[name][start:start + n]

        segments.append({
            "mixer_norm": {"scale": take("mixer_norm")},
            "attn": {k: take(k) for k in ("wq", "wk", "wv", "wo", "q_norm", "k_norm")},
            "ffn_norm": {"scale": take("ffn_norm")},
            "mlp": {k: take(k) for k in ("w_gate", "w_up", "w_down")},
        })
        start += n
    exits = [None] * len(cfg.exit_layers)
    return {"embed": {"w": weights["embed"]}, "segments": segments,
            "final_norm": {"scale": weights["final_norm"]}, "lm_head": {"w": weights["lm_head"]},
            "exits": exits}


def engine(weights: dict, spec: dict, plan, workload: dict, device):
    from repro_torch.offload.engine import lm_engine

    cfg = port_config(spec)
    params = port_params(weights, cfg)
    params["exits"][spec["exit_index"]] = {"norm": {"scale": weights["exit_norm"]},
                                           "head": {"w": weights["exit_head"]}}
    return lm_engine(params, cfg, plan, exit_index=spec["exit_index"], device=device)
