"""Model assembly for the dense decoder family: init, forward, dense-cache
prefill and decode.  The counterpart of ``repro/models/model.py``.

    init_params(cfg, seed, device)        -> params (nested dict of tensors)
    forward(cfg, params, batch)           -> final hidden states (B, S, d)
    init_cache(cfg, batch, seq, device)   -> stacked dense decode cache
    prefill_cached(cfg, params, batch, cache) -> (hidden (B, S, d), cache)
    decode_step(cfg, params, cache, tokens, pos) -> (logits (B, 1, V), cache)

Caches are updated in place; the JAX package returns updated copies.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import (_normal, apply_norm, compute_dtype,
                                       embed_tokens, init_embed, init_norm,
                                       logits_from_hidden, padded_vocab)
from repro_torch.models.transformer import (apply_stack, check_dense,
                                            init_stack, layer_windows)

Params = Dict[str, Any]


def init_params(cfg, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random weights with the JAX package's tree, shapes and init scales,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (the two frameworks draw different numbers from the same seed: tests
    that need identical weights go through ``repro_torch.weights``)."""
    check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p: Params = {"embed": init_embed(cfg, gen, dev)}
    p["layers"] = init_stack(cfg, gen, cfg.n_layers, dev)
    p["final_ln"] = init_norm(cfg, (cfg.d_model,), dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = {"kernel": _normal(
            gen, (cfg.d_model, padded_vocab(cfg.vocab)), cfg.d_model ** -0.5,
            compute_dtype(cfg), dev)}
    return p


def count_params(cfg) -> int:
    """Analytic parameter count of the dense decoder (no allocation)."""
    d, L, f = cfg.d_model, cfg.n_layers, cfg.d_ff
    attn = d * cfg.q_dim * 2 + d * cfg.kv_dim * 2
    mlp = d * f * (3 if cfg.act in ("swiglu", "geglu") else 2)
    norms = d * (2 if cfg.norm == "layernorm" else 1)
    embed = padded_vocab(cfg.vocab) * d
    head = 0 if cfg.tie_embeddings else embed
    return L * (attn + mlp + 2 * norms) + norms + embed + head


def forward(cfg, params: Params, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Full-sequence forward; returns the final normed hidden (B, S, d)."""
    x = embed_tokens(params["embed"], batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = apply_stack(params["layers"], x, cfg, positions=positions,
                       windows=layer_windows(cfg))
    return apply_norm(params["final_ln"], x)


def init_cache(cfg, batch: int, seq: int, device: DeviceLike = None,
               dtype=None) -> Params:
    """Stacked (L, B, seq, Hkv, D) dense decode cache."""
    dev = resolve_device(device)
    dt = dtype or compute_dtype(cfg)
    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"kv": {"k": torch.zeros(shape, dtype=dt, device=dev),
                   "v": torch.zeros(shape, dtype=dt, device=dev)}}


def prefill_cached(cfg, params: Params, batch: Dict[str, torch.Tensor],
                   cache: Params) -> Tuple[torch.Tensor, Params]:
    """Prefill that fills the dense cache from position 0.  Returns the
    final normed hidden (B, S, d) and the cache."""
    x = embed_tokens(params["embed"], batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device, dtype=torch.int32)
    x, cache = apply_stack(params["layers"], x, cfg, positions=positions,
                           windows=layer_windows(cfg), caches=cache,
                           cache_index=0)
    return apply_norm(params["final_ln"], x), cache


def decode_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
                pos: int) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1); pos: the cache fill level.
    Returns (logits (B, 1, V_padded), cache)."""
    x = embed_tokens(params["embed"], tokens, cfg)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    x, cache = apply_stack(params["layers"], x, cfg, positions=positions,
                           windows=layer_windows(cfg), caches=cache,
                           cache_index=pos)
    x = apply_norm(params["final_ln"], x)
    return logits_from_hidden(params, x, cfg), cache
