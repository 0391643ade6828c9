"""Decoder stacks for the dense, MoE and RWKV-6 families: stacked layer
params and a Python loop over layers.  The counterpart of
``repro/models/transformer.py``.

Layer weights keep the JAX package's stacked ``(L, ...)`` layout; the loop
takes the ``i``-th slice of each (a view) where JAX scans over them.  A
dense layer is attn -> mlp, an MoE layer attn -> MoE FFN
(``models/moe.py``), an RWKV layer time-mix -> channel-mix
(``models/rwkv6.py``).  Hybrid-SSM and cross-attention layers come in
later slices.

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

from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv6
from repro_torch.models.layers import (apply_attention, apply_mlp,
                                       apply_norm, init_attention, init_mlp,
                                       init_norm)

Params = Dict[str, Any]

FULL_WINDOW = 1 << 30


def check_dense(cfg) -> None:
    """Raise for the families this slice of the port does not run yet: it
    runs dense and MoE decoders and RWKV-6 stacks."""
    if ((cfg.family not in ("dense", "moe") and not cfg.rwkv)
            or cfg.parallel_ssm or cfg.n_encoder_layers
            or cfg.n_image_tokens or cfg.rope_theta <= 0):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense and MoE decoders and RWKV-6 "
            f"only so far (ROADMAP.md Queue 1 item 6: the other "
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
    p = {"ln1": init_norm(cfg, (n_layers, cfg.d_model), device),
         "ln2": init_norm(cfg, (n_layers, cfg.d_model), device)}
    if cfg.rwkv:
        p["rwkv"] = {
            "tm": rwkv6.init_time_mix(cfg, gen, n_layers, device, dtype),
            "cm": rwkv6.init_channel_mix(cfg, gen, n_layers, device, dtype)}
        return p
    p["attn"] = init_attention(cfg, gen, n_layers, device, dtype)
    if cfg.moe is not None:
        p["moe"] = moe_lib.init_moe(cfg, gen, n_layers, device, dtype)
    else:
        p["mlp"] = init_mlp(cfg, gen, n_layers, device, dtype)
    return p


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


def rwkv_layer(lp: Params, x: torch.Tensor, cfg, *,
               state: Optional[Params] = None) -> torch.Tensor:
    """One RWKV-6 layer (time-mix -> channel-mix).  ``state``: this layer's
    ``{"tm_shift", "wkv", "cm_shift"}`` views of the stacked decode state,
    overwritten with the new state."""
    tm_state = ({"shift": state["tm_shift"], "wkv": state["wkv"]}
                if state is not None else None)
    h, tm_new = rwkv6.apply_time_mix(lp["rwkv"]["tm"],
                                     apply_norm(lp["ln1"], x), cfg,
                                     state=tm_state)
    x = x + h
    cm_state = {"shift": state["cm_shift"]} if state is not None else None
    h, cm_new = rwkv6.apply_channel_mix(lp["rwkv"]["cm"],
                                        apply_norm(lp["ln2"], x), cfg,
                                        state=cm_state)
    if state is not None:
        state["tm_shift"].copy_(tm_new["shift"])
        state["wkv"].copy_(tm_new["wkv"])
        state["cm_shift"].copy_(cm_new["shift"])
    return x + h


def layer_body(lp: Params, x: torch.Tensor, cfg, *,
               positions: torch.Tensor, window: int, causal: bool = True,
               cache: Optional[Params] = None,
               cache_index: Optional[int] = None) -> torch.Tensor:
    """One layer; ``cache`` is written in place.  Dense: attn -> mlp, with
    ``cache`` this layer's ``{"k", "v"}``; MoE: the same with the MoE FFN
    for the MLP (its aux loss is dropped: training an MoE stack waits for
    ROADMAP.md Queue 1 item 11).  RWKV: ``rwkv_layer``, with ``cache``
    this layer's state (positions, window and the cache index play no
    part)."""
    if cfg.rwkv:
        return rwkv_layer(lp, x, cfg, state=cache)
    a, _ = apply_attention(lp["attn"], apply_norm(lp["ln1"], x), cfg,
                           positions=positions, causal=causal,
                           window=window, cache=cache,
                           cache_index=cache_index)
    x = x + a
    return x + ffn(lp, apply_norm(lp["ln2"], x), cfg)


def ffn(lp: Params, xn: torch.Tensor, cfg) -> torch.Tensor:
    """A layer's feed-forward sublayer on the normed ``xn``: the MoE block
    (without its aux loss) where the config has one, else the MLP."""
    if cfg.moe is not None:
        return moe_lib.apply_moe(lp["moe"], xn, cfg)[0]
    return apply_mlp(lp["mlp"], xn, cfg.act)


def apply_stack(p: Params, x: torch.Tensor, cfg, *,
                positions: torch.Tensor, windows: np.ndarray,
                causal: bool = True, caches: Optional[Params] = None,
                cache_index: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Run every layer in order.  ``caches`` is the stacked (L, ...) dense
    cache (``{"kv": ...}``) or RWKV state (``{"rwkv": ...}``), updated in
    place.  Without caches, while a gradient is being recorded, each layer
    runs under ``cfg.remat``.  Returns (x, caches)."""
    for i, lp in enumerate(unstack(p, len(windows))):
        kw = dict(positions=positions, window=int(windows[i]), causal=causal)
        if caches is not None:
            stacked = caches["rwkv"] if cfg.rwkv else caches["kv"]
            cache_l = {k: v[i] for k, v in stacked.items()}
            x = layer_body(lp, x, cfg, cache=cache_l,
                           cache_index=cache_index, **kw)
        elif torch.is_grad_enabled():
            x = remat(functools.partial(layer_body, lp, cfg=cfg, **kw),
                      cfg)(x)
        else:
            x = layer_body(lp, x, cfg, **kw)
    return x, caches
