"""whisper-base [audio] -- enc-dec, conv frontend stubbed, arXiv:2212.04356.

The mel-spectrogram + 2xConv1d frontend is a stub per the assignment:
input_specs provides (batch, 1500, 512) frame embeddings (30 s of audio at
Whisper's 50 Hz encoder rate). This config describes the transformer
backbone: 6-layer bidirectional encoder + 6-layer causal decoder with
cross-attention, LayerNorm + GELU, learned absolute positions.
"""
from repro_torch.configs.base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,  # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    use_rope=False,
    norm_type="layernorm",
    mlp_type="gelu",
    is_encoder_decoder=True,
    encoder_layers=6,
    encoder_seq=1500,
    max_position_embeddings=524_288,  # learned positions sized for the shapes
    exit_layers=(1, 3),
    source="arXiv:2212.04356 (Whisper base: 6L enc + 6L dec, d512 8H ff2048 vocab 51865)",
)

SMOKE = smoke_variant(CONFIG)
