"""Mixtral 8x22B — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf:mistralai/Mixtral-8x22B] 56L d_model=6144 48H
(GQA kv=8) d_ff=16384 vocab=32768, SWA window 4096 (v0.1 lineage).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    n_experts=8, experts_per_token=2, moe_layer_period=1,
    sliding_window=4096, rope_theta=1e6,
)
