"""Llama-4 Maverick 400B-A17B — 128-expert top-1 MoE, early-fusion lineage.

[hf:meta-llama/Llama-4-Maverick-17B-128E; unverified] 48L d_model=5120 40H
(GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.  The early-fusion
multimodal frontend is out of the assigned backbone scope (text shapes).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    n_experts=128, experts_per_token=1, moe_layer_period=1,
    rope_theta=5e5,
)
