"""mamba2-130m [ssm] -- SSD (state-space duality), arXiv:2405.21060."""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,  # attention-free, MLP-free: pure SSD blocks
    vocab_size=50_280,
    head_dim=1,
    use_rope=False,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,  # d_inner=1536 -> 24 SSD heads
    ssm_conv=4,
    ssm_chunk=256,
    ssm_n_groups=1,
    norm_type="rmsnorm",
    tie_embeddings=True,
    exit_layers=(5, 11),  # early exits at 1/4 and 1/2 depth
    source="arXiv:2405.21060 (Mamba-2 130m: 24L d768 state128)",
)

SMOKE = smoke_variant(CONFIG)
