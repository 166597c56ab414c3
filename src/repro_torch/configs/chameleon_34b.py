"""chameleon-34b [vlm] -- early-fusion, VQ image tokens, arXiv:2405.09818.

Early fusion means image patches are VQ-quantized into ordinary vocabulary
ids, so the backbone is a plain decoder over a 65536 mixed-modal vocab; the
VQ-GAN image tokenizer is the stubbed frontend (input_specs provides token
ids directly). Chameleon uses qk-norm for training stability.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22_016,
    vocab_size=65_536,
    qk_norm=True,  # Chameleon's QK-Norm stabilization
    norm_type="rmsnorm",
    exit_layers=(11, 23),
    source="arXiv:2405.09818 (Chameleon-34B: 48L d8192 64H kv8 ff22016 vocab 65536)",
)

SMOKE = smoke_variant(CONFIG)
