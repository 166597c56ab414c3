"""qwen2-72b [dense] -- GQA + QKV bias, arXiv:2407.10671."""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29_568,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    exit_layers=(19, 39),
    source="arXiv:2407.10671 (Qwen2-72B: 80L d8192 64H kv8 ff29568 vocab 152064, QKV bias)",
)

SMOKE = smoke_variant(CONFIG)
