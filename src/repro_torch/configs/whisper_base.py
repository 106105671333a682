"""Whisper base — encoder-decoder audio backbone (stub conv frontend).

[arXiv:2212.04356] 6L enc + 6L dec, d_model=512 8H (MHA) d_ff=2048
vocab=51865.  input_specs() supplies precomputed frame embeddings; decode
shapes run the decoder with self-KV + cross-attention caches.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    head_dim=64, d_ff=2048, vocab_size=51865,
    rope_theta=0.0,                   # sinusoidal absolute positions
    frontend="audio_frames",
)
