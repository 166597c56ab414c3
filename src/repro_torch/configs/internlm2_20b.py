"""internlm2-20b [dense] -- GQA, arXiv:2403.17297."""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16_384,
    vocab_size=92_544,
    norm_type="rmsnorm",
    exit_layers=(11, 23),
    source="arXiv:2403.17297 (InternLM2-20B: 48L d6144 48H kv8 ff16384 vocab 92544)",
)

SMOKE = smoke_variant(CONFIG)
