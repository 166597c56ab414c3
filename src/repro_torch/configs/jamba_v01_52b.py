"""jamba-v0.1-52b [hybrid] -- Mamba+attn 1:7 interleave + MoE, arXiv:2403.19887.

Jamba block structure: in every 8 layers, 1 is attention and 7 are Mamba
(attn_every=8); MoE replaces the dense MLP on every other layer
(moe_every=2), 16 experts top-2. SSM state 16 (Mamba-1 sizing; implemented
here with the SSD scan, noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=65_536,
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=14_336,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,  # attention at layers 4, 12, 20, 28 (1:7 ratio)
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,  # d_inner=8192 -> 128 mamba heads
    ssm_conv=4,
    ssm_chunk=256,
    ssm_n_groups=1,
    use_rope=False,  # Jamba: no positional encoding (Mamba provides order)
    norm_type="rmsnorm",
    exit_layers=(7, 15),
    source="arXiv:2403.19887 (Jamba-v0.1: 32L d4096 32H kv8 ff14336 16e top-2, attn:mamba 1:7)",
)

SMOKE = smoke_variant(CONFIG)
