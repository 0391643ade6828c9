"""Decoder stack for the dense family: stacked layer params and a Python
loop over layers.  The counterpart of ``repro/models/transformer.py``.

Layer weights keep the JAX package's stacked ``(L, ...)`` layout; the loop
takes the ``i``-th slice of each (a view) where JAX scans over them.
MoE, RWKV, hybrid-SSM and cross-attention layers come in later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.layers import (apply_attention, apply_mlp,
                                       apply_norm, init_attention, init_mlp,
                                       init_norm)

Params = Dict[str, Any]

FULL_WINDOW = 1 << 30


def check_dense(cfg) -> None:
    """Raise for the families this slice of the port does not run yet."""
    if (cfg.family != "dense" or cfg.moe is not None or cfg.rwkv
            or cfg.parallel_ssm or cfg.n_encoder_layers
            or cfg.n_image_tokens or cfg.rope_theta <= 0):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense decoders only so far "
            f"(ROADMAP.md Queue 1 item 2: MoE; item 12: the other "
            f"families)")


def layer_windows(cfg) -> np.ndarray:
    """Per-layer attention window (int32).  FULL_WINDOW = global."""
    L = cfg.n_layers
    w = np.full((L,), FULL_WINDOW, np.int32)
    if cfg.sliding_window:
        w[:] = cfg.sliding_window
        if cfg.global_every:  # gemma3: every Nth layer is global
            w[cfg.global_every - 1::cfg.global_every] = FULL_WINDOW
        elif cfg.n_global_layers:  # hymba: first / middle / last
            idx = np.linspace(0, L - 1, cfg.n_global_layers).round().astype(int)
            w[idx] = FULL_WINDOW
    return w


def init_stack(cfg, gen: torch.Generator, n_layers: int, device) -> Params:
    check_dense(cfg)
    return {"ln1": init_norm(cfg, (n_layers, cfg.d_model), device),
            "ln2": init_norm(cfg, (n_layers, cfg.d_model), device),
            "attn": init_attention(cfg, gen, n_layers, device),
            "mlp": init_mlp(cfg, gen, n_layers, device)}


def layer_params(p: Params, i: int) -> Params:
    """Layer ``i``'s slice of a stacked parameter tree (views, no copy)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in p.items()}


def layer_body(lp: Params, x: torch.Tensor, cfg, *,
               positions: torch.Tensor, window: int, causal: bool = True,
               cache: Optional[Params] = None,
               cache_index: Optional[int] = None) -> torch.Tensor:
    """One dense transformer layer (attn -> mlp); ``cache`` is written in
    place."""
    a, _ = apply_attention(lp["attn"], apply_norm(lp["ln1"], x), cfg,
                           positions=positions, causal=causal,
                           window=window, cache=cache,
                           cache_index=cache_index)
    x = x + a
    return x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x), cfg.act)


def apply_stack(p: Params, x: torch.Tensor, cfg, *,
                positions: torch.Tensor, windows: np.ndarray,
                causal: bool = True, caches: Optional[Params] = None,
                cache_index: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Run every layer in order.  ``caches`` is the stacked (L, ...) dense
    cache, updated in place.  Returns (x, caches)."""
    for i in range(len(windows)):
        cache_l = (None if caches is None else
                   {"k": caches["kv"]["k"][i], "v": caches["kv"]["v"][i]})
        x = layer_body(layer_params(p, i), x, cfg, positions=positions,
                       window=int(windows[i]), causal=causal,
                       cache=cache_l, cache_index=cache_index)
    return x, caches
