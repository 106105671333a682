"""Jamba-1.5 Large 398B — hybrid Mamba+attention (1:7) with 16e top-2 MoE.

[arXiv:2403.19887 / Jamba-1.5 tech report; hf:ai21labs] 72L d_model=8192
64H (GQA kv=8) d_ff=24576 vocab=65536.  One attention layer per 8-layer
block (position 0 here), MoE every 2nd layer; SSD mixer with state 128
(we use the Mamba-2/SSD block as the state-space mixer; Jamba v1 used
Mamba-1 — noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    n_experts=16, experts_per_token=2, moe_layer_period=2,
    attn_layer_period=8,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
)
