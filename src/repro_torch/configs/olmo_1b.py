"""olmo-1b [dense] -- non-parametric LayerNorm, arXiv:2402.00838."""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MHA (GQA kv=16)
    d_ff=8192,
    vocab_size=50_304,
    norm_type="nonparametric_ln",  # OLMo: LN without scale/bias
    tie_embeddings=True,
    exit_layers=(3, 7),
    source="arXiv:2402.00838 (OLMo-1B: 16L d2048 16H ff8192 vocab 50304)",
)

SMOKE = smoke_variant(CONFIG)
