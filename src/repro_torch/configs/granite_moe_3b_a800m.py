"""granite-moe-3b-a800m [moe] -- 40 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base family; assigned spec]
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,  # GQA kv=8
    d_ff=0,  # all FFNs are MoE
    vocab_size=49_155,
    moe_num_experts=40,
    moe_top_k=8,
    moe_d_ff=512,
    moe_every=1,
    norm_type="rmsnorm",
    tie_embeddings=True,
    exit_layers=(7, 15),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (assigned: 32L d1536 24H kv8 40e top-8 d_ff 512)",
)

SMOKE = smoke_variant(CONFIG)
