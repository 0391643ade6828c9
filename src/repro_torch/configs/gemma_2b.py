"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

GeGLU, head_dim=256. [arXiv:2403.08295]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    act="geglu",
    rope_theta=10_000.0,
    remat="full",
    tie_embeddings=True,
    supports_long=False,
    max_seq=8192,
))
