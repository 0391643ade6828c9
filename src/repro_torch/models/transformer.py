"""Decoder and encoder stacks: stacked layer params and a Python loop over
layers.  The counterpart of ``repro/models/transformer.py``.

Layer weights keep the JAX package's stacked ``(L, ...)`` layout; the loop
takes the ``i``-th slice of each (a view) where JAX scans over them.  One
layer body covers every family:
  dense / vlm / audio : attn -> mlp
  moe                 : attn -> MoE FFN (``models/moe.py``)
  rwkv                : time-mix -> channel-mix (``models/rwkv6.py``)
  hybrid (hymba)      : parallel(attn, ssm) (mean-fused) -> mlp
                        (``models/ssm.py``)
and a decoder built with ``cross=True`` (whisper) attends to the encoder's
output between its self attention and its MLP.

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
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_attention, apply_cross_attention,
                                       apply_mlp, apply_norm, init_attention,
                                       init_mlp, init_norm)

Params = Dict[str, Any]

FULL_WINDOW = 1 << 30


def check_dense(cfg) -> None:
    """Raise for a config the JAX package does not define a model for: an
    RWKV-6 stack with an SSM branch, an encoder or an image prefix (its
    RWKV layers would build and run none of them)."""
    if cfg.rwkv and (cfg.parallel_ssm or cfg.n_encoder_layers
                     or cfg.n_image_tokens):
        raise NotImplementedError(
            f"{cfg.name}: an RWKV-6 stack takes no SSM branch, encoder or "
            f"image prefix (the JAX package defines no such model)")


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
               dtype: Optional[torch.dtype] = None, *,
               cross: bool = False) -> Params:
    """``dtype``: of the matrices, the compute dtype by default.
    ``cross``: a decoder stack with cross attention (whisper)."""
    check_dense(cfg)
    p = {"ln1": init_norm(cfg, (n_layers, cfg.d_model), device),
         "ln2": init_norm(cfg, (n_layers, cfg.d_model), device)}
    if cfg.rwkv:
        p["rwkv"] = {
            "tm": rwkv6.init_time_mix(cfg, gen, n_layers, device, dtype),
            "cm": rwkv6.init_channel_mix(cfg, gen, n_layers, device, dtype)}
        return p
    p["attn"] = init_attention(cfg, gen, n_layers, device, dtype)
    if cross:
        p["cross"] = init_attention(cfg, gen, n_layers, device, dtype)
        p["ln_cross"] = init_norm(cfg, (n_layers, cfg.d_model), device)
    if cfg.parallel_ssm:
        p["ssm"] = ssm_lib.init_ssm(cfg, gen, n_layers, device, dtype)
        p["ln_attn_out"] = init_norm(cfg, (n_layers, cfg.d_model), device)
        p["ln_ssm_out"] = init_norm(cfg, (n_layers, cfg.d_model), device)
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
               n_prefix: int = 0, enc_out: Optional[torch.Tensor] = None,
               cache: Optional[Params] = None,
               cache_index: Optional[int] = None) -> torch.Tensor:
    """One layer; ``cache`` is this layer's slice of the stacked decode
    cache, by group as in the JAX package (``{"kv": {"k", "v"}, "ssm":
    (B, I, N), "cross": {"k", "v", "cross_filled"}}``, or ``{"rwkv":
    ...}``), written in place.  Attention, with the parallel SSM branch
    mean-fused through ``ln_attn_out`` / ``ln_ssm_out`` where the config
    has one, then cross attention to ``enc_out`` (or to the cached
    encoder K and V) where the layer has it, then the MLP or the MoE FFN
    (whose aux loss is dropped: training an MoE stack waits for
    ROADMAP.md Queue 1 item 11).  RWKV: ``rwkv_layer`` (positions,
    window and the cache index play no part)."""
    cache = cache or {}
    if cfg.rwkv:
        return rwkv_layer(lp, x, cfg, state=cache.get("rwkv"))
    xn = apply_norm(lp["ln1"], x)
    a, _ = apply_attention(lp["attn"], xn, cfg, positions=positions,
                           causal=causal, window=window,
                           cache=cache.get("kv"), cache_index=cache_index,
                           n_prefix=n_prefix)
    if cfg.parallel_ssm:
        s, _ = ssm_lib.apply_ssm(lp["ssm"], xn, cfg, state=cache.get("ssm"))
        a = 0.5 * (apply_norm(lp["ln_attn_out"], a)
                   + apply_norm(lp["ln_ssm_out"], s))
    x = x + a
    if "cross" in lp:
        c, _ = apply_cross_attention(lp["cross"],
                                     apply_norm(lp["ln_cross"], x), cfg,
                                     enc_out=enc_out,
                                     cache=cache.get("cross"))
        x = x + c
    return x + ffn(lp, apply_norm(lp["ln2"], x), cfg)


def ffn(lp: Params, xn: torch.Tensor, cfg) -> torch.Tensor:
    """A layer's feed-forward sublayer on the normed ``xn``: the MoE block
    (without its aux loss) where the config has one, else the MLP."""
    if cfg.moe is not None:
        return moe_lib.apply_moe(lp["moe"], xn, cfg)[0]
    return apply_mlp(lp["mlp"], xn, cfg.act)


def layer_cache(caches: Params, i: int) -> Params:
    """Layer ``i``'s views of a stacked (L, ...) decode cache, by group."""
    return {group: ({k: t[i] for k, t in leaves.items()}
                    if isinstance(leaves, dict) else leaves[i])
            for group, leaves in caches.items()}


def apply_stack(p: Params, x: torch.Tensor, cfg, *,
                positions: torch.Tensor, windows: np.ndarray,
                causal: bool = True, n_prefix: int = 0,
                enc_out: Optional[torch.Tensor] = None,
                caches: Optional[Params] = None,
                cache_index: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Run every layer in order.  ``caches`` is the stacked (L, ...) decode
    cache by group (``{"kv", "ssm", "cross"}`` or ``{"rwkv"}``), updated
    in place.  Without caches, while a gradient is being recorded, each
    layer runs under ``cfg.remat``.  Returns (x, caches)."""
    for i, lp in enumerate(unstack(p, len(windows))):
        kw = dict(positions=positions, window=int(windows[i]), causal=causal,
                  n_prefix=n_prefix, enc_out=enc_out)
        if caches is not None:
            x = layer_body(lp, x, cfg, cache=layer_cache(caches, i),
                           cache_index=cache_index, **kw)
        elif torch.is_grad_enabled():
            x = remat(functools.partial(layer_body, lp, cfg=cfg, **kw),
                      cfg)(x)
        else:
            x = layer_body(lp, x, cfg, **kw)
    return x, caches
