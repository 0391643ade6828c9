"""Plain PyTorch versions of causal GQA flash attention: the counterpart of
``repro/kernels/flash_attention/ref.py`` and the plain versions beside the
CUDA kernels (``kernel.py``).

    attention(q, k, v, ...)                      dense oracle, (B, S, H, D)
    flash_fwd(q, k, v, ..., with_lse)            the forward kernels' function
    flash_bwd(q, k, v, do, lse, dsum, ...)       the backward kernels' function
    group_sum(x, n_q_heads, n_kv_heads)          per-query-head -> per-KV-head

``flash_fwd`` and ``flash_bwd`` take the TPU kernels' flat layout: q, o, do
(B*H, Sq, D); k, v (B*Hkv, Sk, D); lse, dsum (B*H, Sq) fp32.  Query head
row ``b*H + h`` reads KV row ``b*Hkv + h // G``.  Key j is visible to
query i iff ``(not causal or j <= i) and (window <= 0 or i - j < window)``.
Numerics follow the TPU kernels: scores in fp32 from ``fp32(q) * D**-0.5``,
softcap before the mask, masked scores -1e9, p rounded to v's dtype before
the PV product, l floored at 1e-30, ``lse = m + log(l)``; the backward is
``_bwd_block``'s algebra.  ``flash_bwd`` returns dk and dv per QUERY head,
as ``flash_attention_bwd`` does; ``group_sum`` folds them onto the KV heads
(what the CUDA dk/dv kernel writes directly).  Both work over query rows
in chunks, so no (S, S) tensor of a long sequence is whole at once.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

NEG_INF = -1e9
ROW_CHUNK = 1024      # query rows per dense block of the plain versions


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D); window 0 = unlimited.  The
    dense oracle: q scaled in its own dtype, fp32 scores and softmax, p in
    v's dtype for the PV product."""
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    kexp = k.repeat_interleave(G, dim=2)
    vexp = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", (q * D ** -0.5).float(),
                     kexp.float())
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(_mask(Sq, k.shape[1], causal, window, q.device)[None,
                                                                     None],
                    s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                       vexp.float())
    return out.to(q.dtype)


def _mask(Sq: int, Sk: int, causal: bool, window: int, device,
          q0: int = 0) -> torch.Tensor:
    """(Sq, Sk) visibility of keys to queries q0 .. q0 + Sq - 1."""
    qi = torch.arange(q0, q0 + Sq, device=device)[:, None]
    kj = torch.arange(Sk, device=device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        m &= kj <= qi
    if window > 0:
        m &= (qi - kj) < window
    return m


def kv_rows(BH: int, n_q_heads: int, n_kv: int, device) -> torch.Tensor:
    """The KV row each query head row reads: ``b*Hkv + h // G``."""
    H = n_q_heads
    Hkv = n_kv // (BH // H)
    i = torch.arange(BH, device=device)
    return (i // H) * Hkv + (i % H) // (H // Hkv)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              n_q_heads: int, causal: bool = True, window: int = 0,
              softcap: float = 0.0, with_lse: bool = False
              ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """q (B*H, Sq, D), k/v (B*Hkv, Sk, D) -> o (B*H, Sq, D) in q's dtype,
    and with ``with_lse`` also lse (B*H, Sq) fp32."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    rows = kv_rows(BH, n_q_heads, k.shape[0], q.device)
    kf, vf = k.float()[rows], v.float()[rows]
    outs, lses = [], []
    for q0 in range(0, Sq, ROW_CHUNK):
        qf = q[:, q0:q0 + ROW_CHUNK].float() * D ** -0.5
        s = torch.matmul(qf, kf.mT)
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        s = torch.where(_mask(qf.shape[1], Sk, causal, window, q.device, q0),
                        s, NEG_INF)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        l = torch.clamp(p.sum(dim=-1), min=1e-30)
        acc = torch.matmul(p.to(v.dtype).float(), vf)
        outs.append((acc / l[..., None]).to(q.dtype))
        lses.append(m + torch.log(l))
    o = torch.cat(outs, dim=1)
    if with_lse:
        return o, torch.cat(lses, dim=1)
    return o


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, lse: torch.Tensor, dsum: torch.Tensor, *,
              n_q_heads: int, causal: bool = True, window: int = 0,
              softcap: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward from saved lse and ``dsum = sum(do * o, -1)``.  Returns
    (dq (B*H, Sq, D), dk and dv per query head (B*H, Sk, D)), all in q's
    dtype, as ``flash_attention_bwd``."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    scale = D ** -0.5
    rows = kv_rows(BH, n_q_heads, k.shape[0], q.device)
    kf, vf = k.float()[rows], v.float()[rows]
    dqs = []
    dk = torch.zeros((BH, Sk, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, ROW_CHUNK):
        qf = q[:, q0:q0 + ROW_CHUNK].float()
        dof = do[:, q0:q0 + ROW_CHUNK].float()
        s = torch.matmul(qf * scale, kf.mT)
        if softcap > 0.0:
            t = torch.tanh(s / softcap)
            s = t * softcap
        mask = _mask(qf.shape[1], Sk, causal, window, q.device, q0)
        p = torch.where(mask, torch.exp(s - lse[:, q0:q0 + ROW_CHUNK, None]),
                        0.0)
        dp = torch.matmul(dof, vf.mT)
        ds = p * (dp - dsum[:, q0:q0 + ROW_CHUNK, None])
        if softcap > 0.0:
            ds = ds * (1.0 - t * t)
        dqs.append(torch.matmul(ds, kf) * scale)
        dv += torch.matmul(p.mT, dof)
        dk += torch.matmul(ds.mT, qf) * scale
    return (torch.cat(dqs, dim=1).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def group_sum(x: torch.Tensor, n_q_heads: int, n_kv_rows: int
              ) -> torch.Tensor:
    """(B*H, S, D) per query head -> (B*Hkv, S, D) per KV head, summed in
    fp32 over the G query heads of each KV head, in x's dtype."""
    BH, S, D = x.shape
    B = BH // n_q_heads
    Hkv = n_kv_rows // B
    G = n_q_heads // Hkv
    return x.float().reshape(B, Hkv, G, S, D).sum(dim=2).reshape(
        B * Hkv, S, D).to(x.dtype)
