"""Plain PyTorch version of paged-KV attention: the counterpart of
``repro/kernels/paged_attention/ref.py`` (fp pools) and the plain version
beside the CUDA kernel (``kernel.py``).

Layout (vLLM-style): per layer the K/V cache is a pool of ``num_blocks``
pages of ``block_size`` tokens each —

    k_pool, v_pool : (num_blocks, block_size, n_kv_heads, head_dim)

Token position ``p`` of a request lives at page ``table[p // bs]``, offset
``p % bs``.  Physical page 0 is the null block, never read for a live row.

The same live-length contract as the JAX oracle: only the first
``max_live_blocks`` table entries per row are gathered.  Numerics follow
it too: q is scaled by ``D**-0.5`` in its own dtype, dots accumulate in
fp32, softmax is fp32, and p is rounded to the pool dtype before the PV
product.  Rows whose position is -1 (padding) give finite garbage.

One difference from the JAX oracle, in the null block only: the scatter
leaves page 0 untouched for padded rows (JAX writes them there), so the
pools come out bit-equal to the CUDA kernel's, which skips padded rows.
Pools are updated IN PLACE and returned.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e9


def write_kv(k_pool: torch.Tensor, v_pool: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, positions: torch.Tensor,
             block_tables: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter fresh K/V rows into their pages (one layer), in place.

    k_pool/v_pool : (NB, BS, Hkv, D)
    k/v           : (B, S, Hkv, D) fresh projections
    positions     : (B, S) absolute token positions; -1 = padded row
    block_tables  : (B, MB) physical page ids
    """
    NB, BS, Hkv, D = k_pool.shape
    live = positions.reshape(-1) >= 0
    safe = positions.clamp(min=0).long()
    phys = torch.gather(block_tables.long(), 1, safe // BS)
    flat = torch.where(positions >= 0, phys * BS + safe % BS, 0).reshape(-1)
    for pool, new in ((k_pool, k), (v_pool, v)):
        pf = pool.view(NB * BS, Hkv, D)
        rows = new.reshape(-1, Hkv, D).to(pool.dtype)
        # padded rows write the null slot's own bytes back: no host sync
        # for a boolean index, and page 0 stays as it was
        pf[flat] = torch.where(live[:, None, None], rows, pf[flat])
    return k_pool, v_pool


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    positions: torch.Tensor, *, window: int, softcap: float,
                    max_live_blocks: Optional[int] = None) -> torch.Tensor:
    """Attention over block-table-indexed pages (one layer).

    q : (B, S, H, D); positions (B, S) query positions (-1 = padded row).
    Returns (B, S, H, D).  Entries past a row's own live length point at
    pages whose key positions exceed its query position, so the causal
    mask hides them.
    """
    B, S, H, D = q.shape
    NB, BS, Hkv, _ = k_pool.shape
    G = H // Hkv
    MB = block_tables.shape[1]
    L = MB if max_live_blocks is None else max(1, min(int(max_live_blocks),
                                                      MB))
    tables = block_tables[:, :L].long()
    ck = k_pool[tables].reshape(B, L * BS, Hkv, D).to(q.dtype)
    cv = v_pool[tables].reshape(B, L * BS, Hkv, D).to(q.dtype)
    qg = (q * D ** -0.5).reshape(B, S, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), ck.float())
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    k_pos = torch.arange(L * BS, device=q.device)
    qp = positions[:, :, None].long()
    valid = (k_pos[None, None, :] <= qp) & ((qp - k_pos[None, None, :])
                                            < window)        # (B, S, K)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", prob.to(cv.dtype).float(),
                       cv.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def unified_attention_update(q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, block_tables: torch.Tensor,
                             positions: torch.Tensor, *, window: int,
                             softcap: float,
                             max_live_blocks: Optional[int] = None):
    """Scatter every fresh row, then gather and attend: the plain version
    of the fused kernel.  Writing all fresh rows first makes a chunk's
    intra-step predecessors ordinary cache entries for the causal mask.
    Returns (out, k_pool, v_pool), the pools updated in place."""
    write_kv(k_pool, v_pool, k_new, v_new, positions, block_tables)
    out = paged_attention(q, k_pool, v_pool, block_tables, positions,
                          window=window, softcap=softcap,
                          max_live_blocks=max_live_blocks)
    return out, k_pool, v_pool
