"""Paged-KV serving step: pooled cache, per-layer fused scatter + walk, and
the engine's unified ragged tick.  The counterpart of
``repro/serving/paged_attn.py`` on one device.

Layout (vLLM-style): the K/V cache is one pool per tensor

    k, v : (L, num_blocks, block_size, n_kv_heads, head_dim)

in the model dtype, or int8 with ``kv_dtype="int8"``, when two fp32 scale
pools ride beside them (one scale per token row and kv head):

    k_scale, v_scale : (L, num_blocks, block_size, n_kv_heads)

and a request owns pages through a block table (logical block -> physical
page); position ``p`` lives at page ``table[p // bs]``, offset ``p % bs``.
Page 0 is the null block: padded rows point there and nothing correct is
ever read from it.

Where JAX scans over layers with the pools as a carry, this is a Python
loop, and layer ``i`` attends through the contiguous view ``pool[i]``, so
block tables need no per-layer offset.  The pools are updated IN PLACE by
the attention op (the kernel scatters into them); the step returns the
same tensors.  Attention goes through ``repro_torch.kernels.paged_attention
.ops``: the CUDA kernel for CUDA tensors, its plain version for CPU ones.
Tensor parallelism (``tp=``) is a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models.layers import (apply_norm, apply_rope,
                                       compute_dtype, embed_tokens,
                                       logits_from_hidden)
from repro_torch.models.transformer import ffn, layer_windows, unstack

Params = Dict[str, Any]


def supports(cfg) -> bool:
    """Paged KV applies to pure-attention decoder-only stacks."""
    return not (cfg.rwkv or cfg.parallel_ssm or cfg.n_encoder_layers
                or cfg.n_image_tokens)


def init_paged_cache(cfg, num_blocks: int, block_size: int,
                     device: DeviceLike = None, dtype=None,
                     kv_dtype: Optional[str] = None) -> Params:
    """Pooled paged KV cache for the full stack (block 0 = null block).

    ``kv_dtype`` None or ``"fp"``: K/V pools in the model dtype (or
    ``dtype``).  ``"int8"``: int8 K/V pools plus fp32 ``k_scale`` /
    ``v_scale`` pools of shape (L, NB, BS, Hkv), one scale per token row
    and kv head, written by the quantizing scatter and read by the
    dequantizing walk.
    """
    if not supports(cfg):
        raise ValueError("paged cache needs a pure-attention decoder stack")
    if kv_dtype not in (None, "fp", "int8"):
        raise ValueError(f"kv_dtype must be None|'fp'|'int8', "
                         f"got {kv_dtype!r}")
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    if kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)}
    dt = dtype or compute_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    positions: torch.Tensor, *, window: int, softcap: float,
                    max_live_blocks: Optional[int] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over block-table-indexed pages of one layer, read-only.

    q : (B, S, H, D); positions (B, S) query positions (-1 = padded row);
    pools (NB, BS, Hkv, D), with their scale pools when int8.  Returns
    (B, S, H, D).  A thin delegate to the op boundary: the read-only CUDA
    walk for CUDA tensors, its plain version for CPU ones.
    """
    return paged_ops.paged_attention(q, k_pool, v_pool, block_tables,
                                     positions, window=window,
                                     softcap=softcap,
                                     max_live_blocks=max_live_blocks,
                                     k_scale=k_scale, v_scale=v_scale)


def _paged_layer(lp: Params, x: torch.Tensor, cfg, *,
                 positions: torch.Tensor, window: int,
                 k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_tables: torch.Tensor,
                 max_live_blocks: Optional[int],
                 row_map: Optional[torch.Tensor] = None,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer over the paged cache (attn -> mlp, or attn -> MoE FFN),
    mirroring ``transformer.layer_body`` with the dense-cache insert/read
    swapped for the fused paged scatter + walk.  The MoE block routes
    every row handed in, padded rows of the tick's bucket too, as the JAX
    step does.  ``k_scale``/``v_scale``: the layer's scale pools when its
    K/V pools are int8."""
    B, S, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xn = apply_norm(lp["ln1"], x)
    ap = lp["attn"]
    q = (xn @ ap["wq"].to(xn.dtype)).reshape(B, S, h, hd)
    k = (xn @ ap["wk"].to(xn.dtype)).reshape(B, S, hkv, hd)
    v = (xn @ ap["wv"].to(xn.dtype)).reshape(B, S, hkv, hd)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    if row_map is None:
        out = paged_ops.paged_attention_update(
            q, k, v, k_pool, v_pool, block_tables, positions, window=window,
            softcap=cfg.attn_logit_softcap, max_live_blocks=max_live_blocks,
            k_scale=k_scale, v_scale=v_scale)[0]
    else:
        out = paged_ops.paged_attention_unified(
            q, k, v, k_pool, v_pool, block_tables, positions, row_map,
            window=window, softcap=cfg.attn_logit_softcap,
            max_live_blocks=max_live_blocks, k_scale=k_scale,
            v_scale=v_scale)[0]
    x = x + out.reshape(B, S, h * hd) @ ap["wo"].to(x.dtype)
    return x + ffn(lp, apply_norm(lp["ln2"], x), cfg)


def _stack(cfg, params: Params, cache: Params, tokens: torch.Tensor,
           positions: torch.Tensor, block_tables: torch.Tensor, *,
           row_map: Optional[torch.Tensor],
           max_live_blocks: Optional[int]) -> torch.Tensor:
    """Embed + every layer over the paged cache (the shared trunk of
    ``paged_step`` and ``unified_step``).  Returns the final *un-normed*
    hidden states (B, S, d); the pools (and scale pools, with int8
    pages) are written in place."""
    x = embed_tokens(params["embed"], tokens, cfg)
    windows = layer_windows(cfg)
    quant = "k_scale" in cache
    for i, lp in enumerate(unstack(params["layers"], cfg.n_layers)):
        x = _paged_layer(lp, x, cfg,
                         positions=positions, window=int(windows[i]),
                         k_pool=cache["k"][i], v_pool=cache["v"][i],
                         block_tables=block_tables,
                         max_live_blocks=max_live_blocks, row_map=row_map,
                         k_scale=cache["k_scale"][i] if quant else None,
                         v_scale=cache["v_scale"][i] if quant else None)
    return x


def _logits(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + logits for (..., d) hidden."""
    return logits_from_hidden(params, apply_norm(params["final_ln"], x), cfg)


def paged_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
               positions: torch.Tensor, block_tables: torch.Tensor, *,
               max_live_blocks: Optional[int] = None
               ) -> Tuple[torch.Tensor, Params]:
    """Fused step over all rows: decode (S=1) or a prefill chunk (S=C).

    tokens (B, S) int; positions (B, S) int32, -1 for padded entries;
    block_tables (B, MB) int32; ``max_live_blocks`` bounds the walk.
    Returns (logits (B, S, V_padded), cache), the cache updated in place.
    """
    x = _stack(cfg, params, cache, tokens, positions, block_tables,
               row_map=None, max_live_blocks=max_live_blocks)
    return _logits(cfg, params, x), cache


def unified_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
                 positions: torch.Tensor, req_tables: torch.Tensor,
                 row_map: torch.Tensor, verify_idx: torch.Tensor, *,
                 max_live_blocks: Optional[int] = None,
                 max_seg_len: int = 1) -> Tuple[torch.Tensor, Params]:
    """ONE pass over the engine's flat ragged token batch (DESIGN.md §8).

    tokens (T,) packed tokens; positions (T,) int32, -1 for padded
    entries; req_tables (R, MB) int32, one block table per request row;
    row_map (R, max_seg_len) int32, the flat index of each request's s-th
    token (dead entries: a padded flat row); verify_idx (R, W) int32, the
    flat rows whose next-token logits each request needs.

    The trunk runs over the flat batch and attention walks pages once per
    request through ``row_map``.  On a decode-only tick
    (``max_seg_len <= 1``) every flat row already is a whole request, so
    the tables are spread to per-token rows once and the per-layer gather
    is skipped.  Logits exist only at the verify rows.  Returns (logits
    (R, W, V_padded), cache), the cache updated in place.
    """
    if max_seg_len <= 1:
        tok_tables = torch.zeros((tokens.shape[0], req_tables.shape[1]),
                                 dtype=req_tables.dtype,
                                 device=req_tables.device)
        tok_tables[row_map[:, 0].long()] = req_tables
        x = _stack(cfg, params, cache, tokens[:, None], positions[:, None],
                   tok_tables, row_map=None, max_live_blocks=max_live_blocks)
    else:
        x = _stack(cfg, params, cache, tokens[:, None], positions[:, None],
                   req_tables, row_map=row_map,
                   max_live_blocks=max_live_blocks)
    R, W = verify_idx.shape
    xv = x[:, 0][verify_idx.reshape(-1).long()].reshape(R, W, -1)
    return _logits(cfg, params, xv), cache
