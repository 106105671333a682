"""Model / shape configuration system (the port's own copy).

One ``ModelConfig`` dataclass covers every assigned architecture family
(dense / MoE / SSM / hybrid / enc-dec / VLM / audio); per-arch files in this
package instantiate it with the exact published dimensions plus a reduced
``smoke`` twin for CPU tests.  This file is a verbatim copy of the JAX
package's ``repro.configs.base``, so that ``repro_torch`` answers the same
architecture names without importing ``repro``; ``tests/test_torch_kernels.py``
holds the two registries equal field by field.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_layer_period: int = 1      # every k-th layer is MoE (jamba: 2)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    moe_ep: bool = False           # expert-parallel buffers (needs E >= mesh model size)

    # --- attention variants ---
    sliding_window: int = 0        # 0 = full attention; >0 = SWA window

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_layer_period: int = 0     # hybrid: one attn layer per k layers (jamba: 8)

    # --- enc-dec (whisper backbone) ---
    n_enc_layers: int = 0

    # --- stub modality frontend (whisper conv / llava anyres tower) ---
    frontend: str = ""             # "" | "audio_frames" | "vision_patches"
    n_prefix_tokens: int = 0       # patch/frame prefix length inside seq_len

    # ------------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attends(self) -> bool:
        """Has any attention layers at all."""
        return self.family != "ssm"

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            # Jamba: one attention layer per ``attn_layer_period`` block,
            # placed at the start of the block.
            return i % self.attn_layer_period == 0
        return True

    def is_moe_layer(self, i: int) -> bool:
        return self.is_moe and (i % self.moe_layer_period
                                == self.moe_layer_period - 1)

    @property
    def sub_quadratic(self) -> bool:
        """Whether a 500k-token decode is architecturally in-contract."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def smoke(self, **overrides) -> ModelConfig:
        """Reduced same-family twin for CPU smoke tests."""
        small = dict(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            dtype="float32",
        )
        if self.is_moe:
            small.update(n_experts=min(self.n_experts, 4),
                         experts_per_token=min(self.experts_per_token, 2))
        if self.family in ("ssm", "hybrid"):
            small.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if self.family == "hybrid":
            small.update(n_layers=self.attn_layer_period,  # one full block
                         attn_layer_period=self.attn_layer_period)
        if self.n_enc_layers:
            small.update(n_enc_layers=2)
        if self.sliding_window:
            small.update(sliding_window=32)
        if self.n_prefix_tokens:
            small.update(n_prefix_tokens=8)
        small.update(overrides)
        return replace(self, name=self.name + "-smoke", **small)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell: what to lower and at what size."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


LM_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> dict[str, ShapeConfig]:
    """The shape cells that are in-contract for this architecture.

    ``long_500k`` needs sub-quadratic attention: it runs for SSM / hybrid /
    SWA archs and is skipped (documented in DESIGN.md §5) for pure
    full-attention ones.
    """
    out = dict(LM_SHAPES)
    if not cfg.sub_quadratic:
        out.pop("long_500k")
    return out


def param_count(cfg: ModelConfig) -> int:
    """Total parameters (embedding included), analytic."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    total = V * D                          # embedding
    if not cfg.tie_embeddings:
        total += D * V                     # lm head
    n_dec = cfg.n_layers
    for i in range(n_dec):
        total += D                         # final-ish norms amortized below
        if cfg.is_attn_layer(i):
            total += D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
            if cfg.qkv_bias:
                total += (H + 2 * KV) * hd
            total += D                     # attn norm
        else:                              # mamba block
            d_in, N, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            conv_ch = d_in + 2 * N
            total += D * (2 * d_in + 2 * N + nh)      # in_proj
            total += conv_ch * cfg.ssm_conv + conv_ch  # conv + bias
            total += 2 * nh + nh                      # A_log, D, dt_bias
            total += d_in                              # gated norm
            total += d_in * D                          # out_proj
            total += D                                 # block norm
        # FFN (dense or MoE)
        total += D                         # ffn norm
        if cfg.is_moe_layer(i):
            total += D * cfg.n_experts                 # router
            total += cfg.n_experts * 3 * D * F
        else:
            total += 3 * D * F
    # encoder stack (whisper)
    for _ in range(cfg.n_enc_layers):
        total += D * (H * hd) * 2 + 2 * D * (KV * hd) * 0  # enc self-attn q,o
        total += D * (H * hd) + 2 * D * (H * hd)           # k,v (MHA enc)
        total += 3 * D * F + 2 * D
        # decoder cross-attn params counted per decoder layer:
    if cfg.n_enc_layers:
        total += cfg.n_layers * (2 * D * (H * hd) + 2 * D * (KV * hd))  # cross q,o,k,v
    total += D                             # final norm
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: only routed experts)."""
    if not cfg.is_moe:
        return param_count(cfg)
    D, F = cfg.d_model, cfg.d_ff
    dense_expert_savings = 0
    for i in range(cfg.n_layers):
        if cfg.is_moe_layer(i):
            dense_expert_savings += (cfg.n_experts - cfg.experts_per_token) * 3 * D * F
    return param_count(cfg) - dense_expert_savings
