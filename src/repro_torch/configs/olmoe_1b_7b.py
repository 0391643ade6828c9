"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) d_ff=1024 vocab=50304.

MoE 64 experts top-8. [arXiv:2409.02060]
"""
from repro_torch.config import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,                  # per-expert hidden
    vocab=50304,
    act="swiglu",
    moe=MoEConfig(num_experts=64, top_k=8, d_ff=1024),
    rope_theta=10_000.0,
    remat="full",
    tie_embeddings=False,
    supports_long=False,
    max_seq=4096,
))
