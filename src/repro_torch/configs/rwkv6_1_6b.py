"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168 vocab=65536.

RWKV-6 "Finch": data-dependent decay time-mix + channel-mix; constant-size
decode state => runs long_500k. 32 heads x head_dim 64. [arXiv:2404.05892]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                # rwkv-6 internal heads (head_dim=64)
    n_kv_heads=0,              # attention-free
    head_dim=64,
    d_ff=7168,
    vocab=65536,
    act="relu_sq",             # rwkv channel-mix uses squared relu
    norm="layernorm",
    rwkv=True,
    remat="full",
    tie_embeddings=False,
    supports_long=True,
    max_seq=1048576,
))
