"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global attention (sliding window 1024), head_dim=256, 128k context.
Sliding-window-dominant => runs long_500k. [hf:google/gemma-3]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    act="geglu",
    rope_theta=1_000_000.0,
    sliding_window=1024,
    global_every=6,            # layers 5, 11, 17, ... are global (5 local : 1 global)
    remat="full",
    tie_embeddings=True,
    supports_long=True,        # sliding-window dominant; global layers decode O(S) with seq-sharded cache
    max_seq=131072,
))
