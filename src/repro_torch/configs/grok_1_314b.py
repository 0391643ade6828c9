"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072.

MoE 8 experts top-2; attention-logit soft-capping 30; head_dim=128.
314B params => FSDP (ZeRO-3) over the data axis + EP/TP over model axis +
block-quantised int8 optimizer states to fit 16GB/chip on a 256-chip pod.
[hf:xai-org/grok-1]
"""
from repro_torch.config import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,                 # per-expert hidden
    vocab=131072,
    act="geglu",   # xai MoE: linear + linear_v (GLU) + linear_1
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=32768),
    rope_theta=10_000.0,
    attn_logit_softcap=30.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    fsdp=True,
    opt_state_dtype="int8",
    remat="full",
    supports_long=False,
    max_seq=8192,
))
