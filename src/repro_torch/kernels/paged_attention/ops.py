"""Op boundary for paged-KV attention: the counterpart of
``repro/kernels/paged_attention/ops.py``.

The backend follows the tensors' device and nothing else: CPU tensors run
the plain version (``ref.py``), CUDA tensors the hand-written kernels
(``kernel.py``), which raise for anything they do not take.  There is no
switch that sends CUDA tensors to the plain version.  Pools are updated
in place.

    paged_attention(q, k_pool, v_pool, tables, positions, ...) -> out
    paged_attention_update(q, k_new, v_new, k_pool, v_pool, tables,
                           positions, ...) -> (out, k_pool, v_pool)
    paged_attention_unified(q, k_new, v_new, k_pool, v_pool, tables,
                            positions, row_map, ...)
                           -> (out, k_pool, v_pool)   # flat ragged tick
    copy_pages(pools, src, dst) -> pools              # COW, one launch
    copy_page(pool, src, dst) -> pool                 # its one-pool case

With int8 pools (``kv_dtype="int8"``) every attention op also takes
``k_scale=``/``v_scale=`` ((NB, BS, Hkv) fp32 per-row scale pools) and
returns them after the pools: the fresh rows are quantized by one recipe
(``ref.quantize_rows``) on both backends and dequantized in the walk.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.kernels.paged_attention import kernel as _kernel


def _live(block_tables: torch.Tensor, max_live_blocks: Optional[int]) -> int:
    return (block_tables.shape[1] if max_live_blocks is None
            else max_live_blocks)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    positions: torch.Tensor, *, window: int, softcap: float,
                    max_live_blocks: Optional[int] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Read-only paged attention.  q: (B, S, H, D) -> (B, S, H, D).
    ``k_scale``/``v_scale`` (int8 pools) select the dequantizing walk."""
    return _kernel.paged_attention(
        q.contiguous(), k_pool, v_pool, block_tables, positions,
        window=window, softcap=softcap,
        max_live_blocks=_live(block_tables, max_live_blocks),
        k_scale=k_scale, v_scale=v_scale)


def copy_pages(pools: Sequence[torch.Tensor], src,
               dst=None) -> List[torch.Tensor]:
    """Copy one physical page across all layers of every stacked (L, NB,
    ...) pool of a cache, in place, in one launch: the engine's
    copy-on-write primitive.  The pools share L and NB and may differ in
    dtype (K, V and the int8 pages' scale pools), at most
    ``kernel.MAX_POOLS``.  ``src``/``dst`` are host ints, or ``src`` is one
    int32 device tensor {src, dst} and ``dst`` is None (see
    ``kernel.copy_pages``)."""
    return _kernel.copy_pages(pools, src, dst)


def copy_page(pool: torch.Tensor, src, dst=None) -> torch.Tensor:
    """:func:`copy_pages` on one pool: copy one physical page across all
    layers of a stacked (L, NB, ...) pool of any dtype, in place."""
    return _kernel.copy_page(pool, src, dst)


def paged_attention_update(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           positions: torch.Tensor, *, window: int,
                           softcap: float,
                           max_live_blocks: Optional[int] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None):
    """Scatter this step's fresh K/V, then attend.  q: (B, S, H, D).

    Returns (out (B, S, H, D), k_pool, v_pool), plus (k_scale, v_scale)
    with int8 pools.  ``max_live_blocks`` bounds the walk (None: the full
    table width).  Fresh rows go in the pools' dtype, or in q's dtype to
    be quantized when the pools are int8.
    """
    fresh = q.dtype if k_scale is not None else k_pool.dtype
    return _kernel.paged_attention_update(
        q.contiguous(), k_new.to(fresh).contiguous(),
        v_new.to(fresh).contiguous(), k_pool, v_pool, block_tables,
        positions, window=window, softcap=softcap,
        max_live_blocks=_live(block_tables, max_live_blocks),
        k_scale=k_scale, v_scale=v_scale)


def paged_attention_unified(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, req_tables: torch.Tensor,
                            positions: torch.Tensor, row_map: torch.Tensor, *,
                            window: int, softcap: float,
                            max_live_blocks: Optional[int] = None,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None):
    """Scatter + attend over a flat ragged token batch (the unified tick).

    Every flat row carries ONE token (q/k_new/v_new: (T, 1, ...),
    positions (T, 1)); ``req_tables`` (R, MB) int32 is each request's
    block-table row and ``row_map`` (R, max_seg_len) the flat index of
    each request's s-th token, dead entries pointing at a padded flat row
    (position -1).  q/k/v are gathered through ``row_map`` into a
    (R, max_seg_len) multi-query view, walked once per request by
    :func:`paged_attention_update`, and the output is scattered back to
    the flat rows (dead entries all land on padded rows: garbage by
    design).  Returns (out (T, 1, H, D), k_pool, v_pool), plus the scale
    pools with int8 pools.
    """
    T = q.shape[0]
    rm = row_map.long()
    pos_req = positions.reshape(T)[rm]
    res = paged_attention_update(
        q[:, 0][rm], k_new[:, 0][rm], v_new[:, 0][rm], k_pool, v_pool,
        req_tables, pos_req, window=window, softcap=softcap,
        max_live_blocks=max_live_blocks, k_scale=k_scale, v_scale=v_scale)
    out = torch.zeros_like(q)
    out[rm, 0] = res[0]
    return (out,) + tuple(res[1:])
