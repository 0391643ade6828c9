"""Op boundary for paged-KV attention: the counterpart of
``repro/kernels/paged_attention/ops.py`` for fp pools.

The backend follows the tensors' device and nothing else: CPU tensors run
the plain version (``ref.py``), CUDA tensors the hand-written kernel
(``kernel.py``), which raises for anything it does not take.  There is no
switch that sends CUDA tensors to the plain version.  Pools are updated
in place.

    paged_attention_update(q, k_new, v_new, k_pool, v_pool, tables,
                           positions, ...) -> (out, k_pool, v_pool)
    paged_attention_unified(q, k_new, v_new, k_pool, v_pool, tables,
                            positions, row_map, ...)
                           -> (out, k_pool, v_pool)   # flat ragged tick
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_attention import kernel as _kernel


def paged_attention_update(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           positions: torch.Tensor, *, window: int,
                           softcap: float,
                           max_live_blocks: Optional[int] = None):
    """Scatter this step's fresh K/V, then attend.  q: (B, S, H, D).

    Returns (out (B, S, H, D), k_pool, v_pool).  ``max_live_blocks`` bounds
    the walk (None: the full table width).
    """
    live = (block_tables.shape[1] if max_live_blocks is None
            else max_live_blocks)
    return _kernel.paged_attention_update(
        q.contiguous(), k_new.to(k_pool.dtype).contiguous(),
        v_new.to(v_pool.dtype).contiguous(), k_pool, v_pool, block_tables,
        positions, window=window, softcap=softcap, max_live_blocks=live)


def paged_attention_unified(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, req_tables: torch.Tensor,
                            positions: torch.Tensor, row_map: torch.Tensor, *,
                            window: int, softcap: float,
                            max_live_blocks: Optional[int] = None):
    """Scatter + attend over a flat ragged token batch (the unified tick).

    Every flat row carries ONE token (q/k_new/v_new: (T, 1, ...),
    positions (T, 1)); ``req_tables`` (R, MB) int32 is each request's
    block-table row and ``row_map`` (R, max_seg_len) the flat index of
    each request's s-th token, dead entries pointing at a padded flat row
    (position -1).  q/k/v are gathered through ``row_map`` into a
    (R, max_seg_len) multi-query view, walked once per request by
    :func:`paged_attention_update`, and the output is scattered back to
    the flat rows (dead entries all land on padded rows: garbage by
    design).  Returns (out (T, 1, H, D), k_pool, v_pool).
    """
    T = q.shape[0]
    rm = row_map.long()
    pos_req = positions.reshape(T)[rm]
    out_req, k_pool, v_pool = paged_attention_update(
        q[:, 0][rm], k_new[:, 0][rm], v_new[:, 0][rm], k_pool, v_pool,
        req_tables, pos_req, window=window, softcap=softcap,
        max_live_blocks=max_live_blocks)
    out = torch.zeros_like(q)
    out[rm, 0] = out_req
    return out, k_pool, v_pool
