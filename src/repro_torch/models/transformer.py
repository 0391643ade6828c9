"""Decoder stack for the dense family: stacked layer params and a Python
loop over layers.  The counterpart of ``repro/models/transformer.py``.

Layer weights keep the JAX package's stacked ``(L, ...)`` layout; the loop
takes the ``i``-th slice of each (a view) where JAX scans over them.
MoE, RWKV, hybrid-SSM and cross-attention layers come in later slices.

``cfg.remat`` is the JAX package's rematerialisation policy, applied to
each layer body when a gradient is being recorded: ``"full"`` keeps only
the layer's input and recomputes the rest in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint``); ``"dots"`` also keeps
the outputs of the matrix products that have no batch dimensions, the
layer's ``x @ W`` (a selective checkpoint, as
``checkpoint_dots_with_no_batch_dims``); ``"none"`` keeps everything.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

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


def init_stack(cfg, gen: torch.Generator, n_layers: int, device,
               dtype: Optional[torch.dtype] = None) -> Params:
    """``dtype``: of the matrices, the compute dtype by default."""
    check_dense(cfg)
    return {"ln1": init_norm(cfg, (n_layers, cfg.d_model), device),
            "ln2": init_norm(cfg, (n_layers, cfg.d_model), device),
            "attn": init_attention(cfg, gen, n_layers, device, dtype),
            "mlp": init_mlp(cfg, gen, n_layers, device, dtype)}


def unstack(p: Params, n: int) -> List[Params]:
    """The ``n`` layers' parameter trees of a stacked tree: one
    ``torch.unbind`` per leaf (views), so a backward stacks each leaf's
    gradient once instead of adding ``n`` full-size ones."""
    cols = {k: unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
            for k, v in p.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the 2-D matrix products (``x @ W``),
    recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn: Callable, cfg) -> Callable:
    """``fn`` under ``cfg.remat`` (see the module docstring)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


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
    cache, updated in place.  Without caches, while a gradient is being
    recorded, each layer runs under ``cfg.remat``.  Returns (x, caches)."""
    for i, lp in enumerate(unstack(p, len(windows))):
        kw = dict(positions=positions, window=int(windows[i]), causal=causal)
        if caches is not None:
            cache_l = {"k": caches["kv"]["k"][i], "v": caches["kv"]["v"][i]}
            x = layer_body(lp, x, cfg, cache=cache_l,
                           cache_index=cache_index, **kw)
        elif torch.is_grad_enabled():
            x = remat(functools.partial(layer_body, lp, cfg=cfg, **kw),
                      cfg)(x)
        else:
            x = layer_body(lp, x, cfg, **kw)
    return x, caches
