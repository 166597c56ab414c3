"""qwen3-moe-30b-a3b [moe] -- 128 experts top-8, hf:Qwen/Qwen3-30B-A3B."""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,  # all FFNs are MoE
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe_num_experts=128,
    moe_top_k=8,
    moe_d_ff=768,
    moe_every=1,
    norm_type="rmsnorm",
    exit_layers=(11, 23),
    source="hf:Qwen/Qwen3-30B-A3B (48L d2048 32H kv4 128e top-8 d_ff 768 vocab 151936)",
)

SMOKE = smoke_variant(CONFIG)
