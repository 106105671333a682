"""Mamba-2 370M — attention-free SSD (state-space duality) stack.

[arXiv:2405.21060] 48L d_model=1024, ssm_state=128, expand 2 (d_inner 2048,
64-dim heads -> 32 SSD heads), vocab=50280, no FFN (pure mamba blocks),
tied embeddings (GPT-NeoX tokenizer lineage).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    tie_embeddings=True,
)
