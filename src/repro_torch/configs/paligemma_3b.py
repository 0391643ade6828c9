"""paligemma-3b [vlm]: gemma-2b backbone + SigLIP patch-embedding stub.

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216; 256 image tokens
(prefix, bidirectional) + causal text. [arXiv:2407.07726]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    act="geglu",
    rope_theta=10_000.0,
    n_image_tokens=256,
    remat="full",
    tie_embeddings=True,
    supports_long=False,
    max_seq=8192,
))
