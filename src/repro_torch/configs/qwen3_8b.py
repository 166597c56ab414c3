"""qwen3-8b [dense] -- qk_norm + GQA, hf:Qwen/Qwen3-8B."""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12_288,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    exit_layers=(8, 17),
    source="hf:Qwen/Qwen3-8B (36L d4096 32H kv8 ff12288 vocab 151936, qk_norm)",
)

SMOKE = smoke_variant(CONFIG)
