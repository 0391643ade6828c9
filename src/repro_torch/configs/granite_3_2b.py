"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.

[hf:ibm-granite/granite-3.0-2b-base]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
    act="swiglu",
    rope_theta=10_000.0,
    remat="full",
    tie_embeddings=True,
    supports_long=False,
    max_seq=4096,
))
