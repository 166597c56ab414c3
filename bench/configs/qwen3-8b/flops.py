"""The frozen FLOP count of Qwen3 at prefill, split at an exit: what the
algorithm needs per sequence, 2 per multiply-add.

Per token and layer: the q, k, v and output projections and the three
SwiGLU products. Per layer and sequence: the causal half of the attention
scores and of the values (query i reads keys 0..i). The exit head and the
final head at the last position only, as the port computes them. Norms,
RoPE, softmax and activations count 0.
"""
from __future__ import annotations


def _layer_terms(spec, s):
    d, ff = spec["hidden_size"], spec["intermediate_size"]
    qh, kvh, hd = spec["num_attention_heads"], spec["num_key_value_heads"], spec["head_dim"]
    proj = 2 * (d * qh * hd + 2 * d * kvh * hd + qh * hd * d + 3 * d * ff)
    attn = 2 * 2 * qh * hd * (s * (s + 1) // 2)
    return s * proj, attn


def per_row(spec: dict, workload: dict):
    """(edge FLOPs, cloud FLOPs) for one sequence of the workload's length."""
    s = workload["seq_len"]
    proj, attn = _layer_terms(spec, s)
    head = 2 * spec["hidden_size"] * spec["vocab_size"]
    edge_layers = spec["exit_layer"] + 1
    cloud_layers = spec["num_hidden_layers"] - edge_layers
    return edge_layers * (proj + attn) + head, cloud_layers * (proj + attn) + head


def attention_per_row(spec: dict, workload: dict):
    """(edge, cloud) FLOPs of the causal attention alone, for the cross-check
    against a count of what the port executes (full score matrices)."""
    _, attn = _layer_terms(spec, workload["seq_len"])
    edge_layers = spec["exit_layer"] + 1
    return edge_layers * attn, (spec["num_hidden_layers"] - edge_layers) * attn
