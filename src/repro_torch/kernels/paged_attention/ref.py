"""Plain PyTorch version of paged-KV attention: the counterpart of
``repro/kernels/paged_attention/ref.py`` and the plain version beside the
CUDA kernels (``kernel.py``).

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

int8 pools (``kv_dtype="int8"``): the K/V pools hold int8 rows and
parallel fp32 scale pools ``k_scale``/``v_scale`` (NB, BS, Hkv) hold one
scale per (token row, kv head).  :func:`quantize_rows` is the one recipe
both the plain scatter and the kernel's wrapper use, so int8 pools come
out bit-equal on every path; the walk dequantizes in fp32.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

NEG_INF = -1e9


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization, one fp32 scale per (token row, kv
    head): the JAX ``ref.quantize_rows`` recipe, bit for bit.

    x : (..., D).  Returns ``(q, scale)``: ``scale = amax(|x|) *
    fp32(1/127)`` over the trailing axis (a multiply by the fp32 constant,
    not a division), and ``q = clip(round(x * inv), -127, 127)`` as int8
    with ``inv = 1 / scale`` guarded to 0 for an all-zero row.
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    xf = x.float()
    # the Python float enters the product as an fp32 scalar: fp32(1/127)
    scale = xf.abs().amax(dim=-1) * (1.0 / 127.0)
    inv = torch.where(scale > 0, torch.reciprocal(scale),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(xf * inv[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: fp32 ``q * scale`` (broadcast over
    head_dim)."""
    return q.float() * scale[..., None].float()


def copy_page(pool: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """Copy physical page ``src`` over page ``dst`` in every layer of a
    stacked (L, NB, ...) pool, in place (the copy-on-write primitive).
    Returns the pool."""
    pool[:, dst] = pool[:, src]
    return pool


def copy_pages(pools: Sequence[torch.Tensor], src: int,
               dst: int) -> List[torch.Tensor]:
    """:func:`copy_page` on each pool in turn (a copy-on-write over a whole
    cache: K, V and, with int8 pages, their scale pools).  Returns the
    pools as a list."""
    return [copy_page(pool, src, dst) for pool in pools]


def _scatter_rows(pool: torch.Tensor, rows: torch.Tensor, flat: torch.Tensor,
                  live: torch.Tensor) -> None:
    """pool viewed as (NB * BS, ...) gets ``rows`` at ``flat``; padded rows
    write the null slot's own bytes back (no host sync for a boolean
    index, and page 0 stays as it was)."""
    pf = pool.view(-1, *pool.shape[2:])
    keep = live.reshape(-1, *([1] * (rows.dim() - 1)))
    pf[flat] = torch.where(keep, rows.to(pool.dtype), pf[flat])


def write_kv(k_pool: torch.Tensor, v_pool: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, positions: torch.Tensor,
             block_tables: torch.Tensor,
             k_scale: Optional[torch.Tensor] = None,
             v_scale: Optional[torch.Tensor] = None):
    """Scatter fresh K/V rows into their pages (one layer), in place.

    k_pool/v_pool : (NB, BS, Hkv, D)
    k/v           : (B, S, Hkv, D) fresh projections
    positions     : (B, S) absolute token positions; -1 = padded row
    block_tables  : (B, MB) physical page ids
    k_scale/v_scale : (NB, BS, Hkv) fp32 scale pools, present iff the
                      pools are int8: the fresh rows are quantized here
                      (:func:`quantize_rows`) and their scales land in the
                      same slots.

    Returns (k_pool, v_pool), or (k_pool, v_pool, k_scale, v_scale) with
    scale pools.
    """
    NB, BS, Hkv, D = k_pool.shape
    live = positions.reshape(-1) >= 0
    safe = positions.clamp(min=0).long()
    phys = torch.gather(block_tables.long(), 1, safe // BS)
    flat = torch.where(positions >= 0, phys * BS + safe % BS, 0).reshape(-1)
    if k_scale is None:
        for pool, new in ((k_pool, k), (v_pool, v)):
            _scatter_rows(pool, new.reshape(-1, Hkv, D), flat, live)
        return k_pool, v_pool
    for pool, spool, new in ((k_pool, k_scale, k), (v_pool, v_scale, v)):
        q, s = quantize_rows(new.reshape(-1, Hkv, D))
        _scatter_rows(pool, q, flat, live)
        _scatter_rows(spool, s, flat, live)
    return k_pool, v_pool, k_scale, v_scale


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    positions: torch.Tensor, *, window: int, softcap: float,
                    max_live_blocks: Optional[int] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over block-table-indexed pages (one layer).

    q : (B, S, H, D); positions (B, S) query positions (-1 = padded row).
    Returns (B, S, H, D).  Entries past a row's own live length point at
    pages whose key positions exceed its query position, so the causal
    mask hides them.  With ``k_scale``/``v_scale`` the pools are int8 and
    each gathered page is dequantized in fp32 first.
    """
    B, S, H, D = q.shape
    NB, BS, Hkv, _ = k_pool.shape
    G = H // Hkv
    MB = block_tables.shape[1]
    L = MB if max_live_blocks is None else max(1, min(int(max_live_blocks),
                                                      MB))
    tables = block_tables[:, :L].long()
    if k_scale is not None:
        ck = dequantize(k_pool[tables], k_scale[tables])
        cv = dequantize(v_pool[tables], v_scale[tables])
    else:
        ck, cv = k_pool[tables], v_pool[tables]
    ck = ck.reshape(B, L * BS, Hkv, D).to(q.dtype)
    cv = cv.reshape(B, L * BS, Hkv, D).to(q.dtype)
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
                             max_live_blocks: Optional[int] = None,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None):
    """Scatter every fresh row, then gather and attend: the plain version
    of the fused kernel.  Writing all fresh rows first makes a chunk's
    intra-step predecessors ordinary cache entries for the causal mask.
    Returns (out, k_pool, v_pool), the pools updated in place, and the
    scale pools after them when the pools are int8."""
    pools = write_kv(k_pool, v_pool, k_new, v_new, positions, block_tables,
                     k_scale, v_scale)
    out = paged_attention(q, k_pool, v_pool, block_tables, positions,
                          window=window, softcap=softcap,
                          max_live_blocks=max_live_blocks,
                          k_scale=k_scale, v_scale=v_scale)
    return (out,) + pools
