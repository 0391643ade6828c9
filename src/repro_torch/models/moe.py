"""Mixture-of-Experts block (grok-1: 8 experts top-2; olmoe: 64 top-8).  The
counterpart of ``init_moe``, ``capacity``, ``apply_moe`` and ``aux_loss`` in
``repro/models/moe.py`` (its shard_map dispatch waits for multi-GPU
sharding, ROADMAP.md Queue 1 item 7).

Dispatch is sort-based, dropless up to a capacity factor: the router runs
in fp32, its top-k gates are renormalised, every (token, choice)
assignment is ranked within its expert by a stable sort of the flat expert
ids (earlier tokens first), and those ranked ``C`` or later are dropped.
The kept rows go into a dense (E, C, d) buffer, the experts run as batched
products over it (``torch.bmm``), and each token sums its k gated
contributions.  Those sit next to each other (assignment ``i`` belongs to
token ``i // k``), so the combine is a sum over a (T, k, d) view in a fixed
order, not a scatter-add, whose CUDA atomics would add in a varying order.
A dropped assignment contributes zero.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal, compute_dtype

Params = Dict[str, Any]


def init_moe(cfg, gen: torch.Generator, n_layers: int, device,
             dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX package's tree and init scales; the router is fp32 whatever
    ``dtype`` (of the expert matrices, the compute dtype by default)."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff, m.num_experts
    L = (n_layers,) if n_layers else ()
    dt = dtype or compute_dtype(cfg)
    p: Params = {"router": _normal(gen, L + (d, E), d ** -0.5,
                                   torch.float32, device)}
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = _normal(gen, L + (E, d, f), d ** -0.5, dt, device)
        p["wu"] = _normal(gen, L + (E, d, f), d ** -0.5, dt, device)
    else:
        p["wi"] = _normal(gen, L + (E, d, f), d ** -0.5, dt, device)
    p["wo"] = _normal(gen, L + (E, f, d), f ** -0.5, dt, device)
    return p


def capacity(n_tokens: int, cfg) -> int:
    """Rows of each expert's buffer: ``n_tokens * k * capacity_factor / E``
    rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k * m.capacity_factor
                      / m.num_experts))
    return max(8, -(-c // 8) * 8)


@dataclass
class Routing:
    """One call's routing over T tokens and k choices each (flat index
    ``i`` = token ``i // k``, choice ``i % k``)."""
    logits: torch.Tensor      # (T, E) fp32 router logits
    gates: torch.Tensor       # (T, k) fp32, renormalised to sum 1
    expert_ids: torch.Tensor  # (T, k) int64
    keep: torch.Tensor        # (T*k,) bool: within its expert's capacity
    dest: torch.Tensor        # (T*k,) row of the (E*C, d) buffer; E*C drops


def route(router: torch.Tensor, xf: torch.Tensor, cfg, C: int) -> Routing:
    """Router, top-k and the capacity-limited slots of ``xf`` (T, d)."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    logits = xf.float() @ router.float()
    gates, expert_ids = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = expert_ids.reshape(-1)
    sorted_ids, order = torch.sort(flat, stable=True)
    starts = torch.searchsorted(sorted_ids,
                                torch.arange(E, device=flat.device))
    rank = torch.arange(flat.numel(), device=flat.device) \
        - starts[sorted_ids]
    slot = torch.empty_like(rank).scatter_(0, order, rank)
    keep = slot < C
    dest = torch.where(keep, flat * C + slot, E * C)
    return Routing(logits, gates, expert_ids, keep, dest)


def _experts(p: Params, buf: torch.Tensor, act: str) -> torch.Tensor:
    """Every expert's FFN over its (C, d) rows of ``buf`` (E, C, d)."""
    dt = buf.dtype
    if act in ("swiglu", "geglu"):
        g = torch.bmm(buf, p["wg"].to(dt))
        u = torch.bmm(buf, p["wu"].to(dt))
        g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * u
    else:
        h = F.gelu(torch.bmm(buf, p["wi"].to(dt)), approximate="tanh")
    return torch.bmm(h, p["wo"].to(dt))


def apply_moe(p: Params, x: torch.Tensor, cfg, cap: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> ((B, S, d), the load-balancing aux loss).  ``T =
    B * S`` counts every row handed in, padded rows too; ``cap`` overrides
    :func:`capacity`."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.num_experts, m.top_k
    C = cap if cap is not None else capacity(T, cfg)
    xf = x.reshape(T, d)
    r = route(p["router"], xf, cfg, C)
    # one spare row takes every dropped assignment and is never read
    buf = x.new_zeros((E * C + 1, d))
    buf[r.dest] = xf.repeat_interleave(k, dim=0)
    out_buf = _experts(p, buf[:E * C].view(E, C, d), cfg.act)
    got = out_buf.reshape(E * C, d)[r.dest.clamp_max(E * C - 1)]
    got = torch.where(r.keep[:, None], got, 0.0)
    weighted = got * r.gates.reshape(-1, 1).to(x.dtype)
    out = weighted.view(T, k, d).sum(1)
    return out.reshape(B, S, d), aux_loss(r.logits, r.expert_ids, E)


def aux_loss(router_logits: torch.Tensor, expert_ids: torch.Tensor,
             E: int) -> torch.Tensor:
    """Switch-style load-balancing loss: ``E * sum(mean prob * mean
    dispatch)`` over the experts."""
    me = torch.softmax(router_logits, dim=-1).mean(0)
    ce = F.one_hot(expert_ids, E).sum(1).float().mean(0)
    return E * torch.sum(me * ce)
