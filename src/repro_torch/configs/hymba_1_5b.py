"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001.

Parallel attention + mamba heads in every layer (mean-fused), ssm_state=16;
sliding-window attention except 3 global layers => runs long_500k.
[arXiv:2411.13676]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    act="swiglu",
    rope_theta=10_000.0,
    ssm_state=16,
    parallel_ssm=True,
    sliding_window=1024,
    n_global_layers=3,          # first/middle/last layers use full attention
    remat="full",
    tie_embeddings=True,
    supports_long=True,
    max_seq=32768,
))
