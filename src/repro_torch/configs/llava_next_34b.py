"""LLaVA-NeXT 34B — VLM: anyres-tiled vision prefix + dense GQA LM.

[hf:llava-hf/llava-v1.6-34b-hf lineage; unverified] 60L d_model=7168 56H
(GQA kv=8) d_ff=20480 vocab=64000.  The anyres vision tower + projector is
a STUB: input_specs() provides 2880 precomputed patch embeddings (5 tiles x
576 patches) at d_model as a prefix; loss runs over the text positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000, rope_theta=5e6,
    frontend="vision_patches", n_prefix_tokens=2880,
)
