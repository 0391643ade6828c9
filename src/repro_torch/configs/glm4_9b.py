"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.

Partial RoPE (half the head dim), GQA. [hf:THUDM/glm-4-9b]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    act="swiglu",
    rope_theta=10_000.0,
    rope_fraction=0.5,
    remat="full",
    tie_embeddings=False,
    supports_long=False,
    max_seq=131072,
))
