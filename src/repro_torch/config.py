"""Configuration system for the PyTorch port (a copy of ``repro/config.py``).

The port keeps its own copy so that it never imports the JAX package;
only the architectures the port serves so far are registered
(``repro_torch/configs``).  Every architecture is a :class:`ModelConfig`;
every workload shape is a :class:`ShapeConfig`.  Configs are plain frozen
dataclasses so they hash and serialise to/from dicts.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden size
    router_jitter: float = 0.0
    # capacity factor used for the (dense-compatible) EP dispatch
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attention-free)
    n_kv_heads: int                  # kv heads (GQA); == n_heads for MHA; 0 for attn-free
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    act: str = "swiglu"              # swiglu | geglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0       # glm4 uses partial rotary (0.5)
    tie_embeddings: bool = True
    # sliding-window / local-global attention
    sliding_window: int = 0          # 0 = full attention everywhere
    global_every: int = 0            # e.g. 6 -> layers 5, 11, ... are global (gemma3 5:1)
    # MoE
    moe: Optional[MoEConfig] = None
    # SSM / RWKV
    ssm_state: int = 0               # mamba-style state size (hymba)
    rwkv: bool = False               # RWKV-6 time-mix blocks instead of attention
    # hybrid (hymba): parallel attention + ssm heads in every layer
    parallel_ssm: bool = False
    n_global_layers: int = 0         # hymba/gemma3: how many layers use full attn
    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 0             # fixed encoder length (whisper: 1500 frames)
    # VLM (paligemma)
    n_image_tokens: int = 0          # prefix patch-embedding tokens
    # numerics / memory
    dtype: str = "bfloat16"          # activation/param compute dtype
    param_dtype: str = "float32"     # master param dtype
    remat: str = "none"              # none | dots | full
    fsdp: bool = False               # additionally shard params over the data axis
    opt_state_dtype: str = "float32" # float32 | bfloat16 | int8 (block-quantised)
    logit_softcap: float = 0.0       # grok/gemma-style tanh soft-capping
    attn_logit_softcap: float = 0.0
    # which workload shapes this arch supports
    supports_long: bool = False      # run long_500k?
    max_seq: int = 0                 # informational
    # ---- perf knobs (hillclimbed in EXPERIMENTS.md §Perf) ----
    wkv_block: int = 1               # tokens per wkv scan step (state HBM
                                     # round-trips drop by this factor)
    ssm_block: int = 1               # same for the mamba selective scan
    ssm_constrain: bool = False      # sharding-constrain the scan state
    moe_impl: str = "gspmd"          # gspmd | shard_map (explicit EP)
    sp_attention: bool = False       # sequence-parallel attention: q-chunks
                                     # vmapped + sharded over the model axis
                                     # (wins when heads % tp != 0)
    q_chunk: int = 512               # flash q-block (sp: make nq >= tp)
    k_chunk: int = 1024              # flash k-block
    microbatches: int = 1            # gradient-accumulation microbatches
                                     # (activation memory / this factor)
    scan_layers: bool = True         # lax.scan over stacked layers; False
                                     # unrolls (static per-layer windows ->
                                     # Pallas attention eligible)
    use_pallas_attention: bool = False  # TPU target: flash-attention kernel
                                        # (requires scan_layers=False)
    use_pallas_wkv: bool = False     # TPU target: wkv6 recurrence kernel

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attention_free(self) -> bool:
        return self.rwkv

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count of the dense decoder stack."""
        from repro_torch.models.model import count_params
        return count_params(self)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Workload shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The shape cells assigned to this architecture.

    ``long_500k`` requires sub-quadratic attention: it runs only for
    SSM / hybrid / sliding-window-dominant archs (cfg.supports_long).
    """
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long:
        out.append(LONG_500K)
    return tuple(out)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    assert cfg.name not in _REGISTRY, f"duplicate arch {cfg.name}"
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def _ensure_loaded() -> None:
    # import all config modules once, which register themselves
    if _REGISTRY:
        return
    from repro_torch import configs  # noqa: F401  (side-effect: registration)


def reduced(cfg: ModelConfig, **overrides: Any) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small: Dict[str, Any] = dict(
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab=257,
        head_dim=16,
        dtype="float32",
        param_dtype="float32",
        remat="none",
        fsdp=False,
        opt_state_dtype="float32",
    )
    if cfg.n_heads:
        small["n_heads"] = 4
        small["n_kv_heads"] = max(1, min(cfg.n_kv_heads, 2))
    if cfg.moe is not None:
        # capacity_factor high enough to be dropless: full-seq forward and
        # cached prefill/decode then agree exactly (capacity drops are
        # batch-composition dependent and would break consistency tests)
        small["moe"] = MoEConfig(num_experts=4, top_k=min(2, cfg.moe.top_k),
                                 d_ff=64, capacity_factor=8.0)
    if cfg.n_encoder_layers:
        small["n_encoder_layers"] = 2
        small["encoder_seq"] = 16
    if cfg.n_image_tokens:
        small["n_image_tokens"] = 8
    if cfg.sliding_window:
        small["sliding_window"] = 8
    if cfg.ssm_state:
        small["ssm_state"] = 4
    if cfg.n_global_layers:
        small["n_global_layers"] = 1
    small["name"] = cfg.name + "-smoke"
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
