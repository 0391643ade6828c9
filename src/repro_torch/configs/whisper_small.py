"""whisper-small [audio]: enc-dec transformer backbone, conv frontend stubbed.

12L decoder + 12L encoder, d_model=768, 12H (kv=12), d_ff=3072, vocab=51865.
[arXiv:2212.04356]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,               # decoder layers
    n_encoder_layers=12,
    encoder_seq=1500,          # precomputed audio-frame embeddings (stub frontend)
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    act="gelu",
    norm="layernorm",
    rope_theta=0.0,            # whisper uses absolute positions (learned)
    remat="full",
    tie_embeddings=True,
    supports_long=False,       # full attention
    max_seq=32768,
))
