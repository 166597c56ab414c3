"""Config system: architecture + input-shape configs (port of
`repro.configs.base`).

A verbatim copy of the reference's `ModelConfig`, `ShapeConfig`,
`INPUT_SHAPES` and `smoke_variant`, so the port never imports `repro`.
Every architecture module beside this one exports ``CONFIG`` (the exact
assigned spec) and ``SMOKE`` (a reduced variant of the same family: <=2
layers, d_model<=512, <=4 experts) used by CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. All models in the zoo are driven by this."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | convnet
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention features -------------------------------------------------
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 = full causal; >0 = window size
    use_rope: bool = True

    # --- norm / mlp ---------------------------------------------------------
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    mlp_type: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False

    # --- MoE ----------------------------------------------------------------
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim
    moe_every: int = 1  # apply MoE on layers where (i % moe_every == moe_offset)
    moe_offset: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01
    # perf-pass flags (off = paper-faithful baseline; see EXPERIMENTS.md #Perf)
    moe_shard_capacity: bool = False  # shard dispatch capacity dim over data
    decode_unroll: bool = False  # unroll decode layers; in-place stacked cache
    mamba_split_proj: bool = False  # split dt out of in_proj so it TP-shards

    # --- SSM (Mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 64
    ssm_n_groups: int = 1

    # --- hybrid (Jamba): attention on layers where i % attn_every == attn_offset
    attn_every: int = 0  # 0 = attention everywhere (or nowhere for pure ssm)
    attn_offset: int = 0

    # --- encoder-decoder (Whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0  # stubbed frontend: precomputed frame embeddings
    max_position_embeddings: int = 0  # learned pos-emb size (0 = none/rope)

    # --- early exits (the paper's technique) ---------------------------------
    exit_layers: Tuple[int, ...] = ()  # exit head after block i (0-based)
    exit_loss_weights: Tuple[float, ...] = ()  # per-exit loss weight (training)

    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"
    source: str = ""  # citation

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.exit_layers and not self.exit_loss_weights:
            object.__setattr__(
                self, "exit_loss_weights", tuple(1.0 for _ in self.exit_layers)
            )

    # ------------------------------------------------------------------ utils
    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_plan(self):
        """Per-layer (mixer, ffn) kinds.

        mixer: 'attn' | 'mamba'      ffn: 'dense' | 'moe' | 'none'
        """
        plan = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                mixer = "mamba"
            elif self.family == "hybrid":
                mixer = (
                    "attn" if (i % self.attn_every) == self.attn_offset else "mamba"
                )
            else:
                mixer = "attn"
            if self.moe_num_experts > 0 and (i % self.moe_every) == self.moe_offset:
                ffn = "moe"
            elif self.d_ff > 0:
                ffn = "dense"
            else:
                ffn = "none"
            plan.append((mixer, ffn))
        return plan

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, hd = self.d_model, self.head_dim
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size  # lm head
        for mixer, ffn in self.layer_plan():
            if mixer == "attn":
                n += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                n += self.num_heads * hd * d
                if self.qkv_bias:
                    n += (self.num_heads + 2 * self.num_kv_heads) * hd
            else:
                di, st, g = self.d_inner, self.ssm_state, self.ssm_n_groups
                # in_proj -> [z, x, B, C, dt]; conv over x,B,C; A,D,dt_bias; out
                conv_ch = di + 2 * g * st
                n += d * (2 * di + 2 * g * st + self.ssm_heads)
                n += self.ssm_conv * conv_ch
                n += 3 * self.ssm_heads
                n += di * d + di  # out_proj + gated-norm scale
            if ffn == "dense":
                mult = 3 if self.mlp_type == "swiglu" else 2
                n += mult * d * self.d_ff
            elif ffn == "moe":
                mult = 3 if self.mlp_type == "swiglu" else 2
                n += d * self.moe_num_experts  # router
                n += self.moe_num_experts * mult * d * self.moe_d_ff
            n += 2 * d if self.norm_type != "nonparametric_ln" else 0
        for _ in self.exit_layers:
            n += d * self.vocab_size + (d if self.norm_type != "nonparametric_ln" else 0)
        if self.is_encoder_decoder:
            # encoder self-attn+mlp, decoder cross-attn
            enc = self.encoder_layers * (
                4 * d * self.num_heads * hd + 2 * d * self.d_ff + 2 * d
            )
            dec_cross = self.num_layers * (
                2 * d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + d
            )
            n += enc + dec_cross + self.encoder_seq * d
        if self.max_position_embeddings:
            n += self.max_position_embeddings * d
        return n

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k of num_experts)."""
        if self.moe_num_experts == 0:
            return self.param_count()
        n = self.param_count()
        mult = 3 if self.mlp_type == "swiglu" else 2
        per_expert = mult * self.d_model * self.moe_d_ff
        n_moe_layers = sum(1 for _, f in self.layer_plan() if f == "moe")
        n -= n_moe_layers * (self.moe_num_experts - self.moe_top_k) * per_expert
        return n

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: <=2 layers, d_model<=512, <=4 experts."""
    d = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads)
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=d,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d // heads if heads else 0,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
    )
    if cfg.moe_num_experts:
        kw.update(
            moe_num_experts=4,
            moe_top_k=min(cfg.moe_top_k, 2),
            moe_d_ff=min(cfg.moe_d_ff, 128),
        )
    if cfg.ssm_state:
        kw.update(ssm_state=min(cfg.ssm_state, 16), ssm_head_dim=32, ssm_chunk=16)
    if cfg.is_encoder_decoder:
        kw.update(encoder_layers=2, encoder_seq=max(16, min(cfg.encoder_seq, 32)))
    if cfg.max_position_embeddings:
        kw.update(max_position_embeddings=4096)
    if cfg.attn_every:
        kw.update(attn_every=2, attn_offset=cfg.attn_offset % 2)
    if cfg.exit_layers:
        kw.update(exit_layers=(0,), exit_loss_weights=(1.0,))
    return cfg.replace(**kw)
