"""Mamba-style selective-scan (S6) head of hymba's parallel SSM branch, in
PyTorch.  The counterpart of ``repro/models/ssm.py``.

Per head with channel dim D and state size N:
    dt_t = softplus(x_t @ Wdt + b)                (B, S, D)
    B_t, C_t = x_t @ Wb, x_t @ Wc                 (B, S, N)
    h_t = h_{t-1} * exp(dt_t[:, None] * A) + (dt_t * x_t)[:, None] * B_t
    y_t = h_t . C_t + D_skip * x_t

The JAX package runs the recurrence as a ``lax.scan`` with no Pallas
kernel.  The port runs it in plain PyTorch as an associative scan: over
chunks of ``SCAN_CHUNK`` tokens, carrying the state from chunk to chunk,
and within a chunk in log2(chunk) steps of whole-chunk operations
(Hillis-Steele), the same recurrence in another association order.  A
Python loop over tokens would launch a few kernels a token and layer, and
leave the card idle.  The state, ``dt``, ``B`` and ``C`` and their
projections are fp32 whatever the compute dtype, as in JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal, compute_dtype

Params = Dict[str, Any]

# Tokens a chunk of the scan: bounds the (B, chunk, I, N) fp32 tensors each
# of its log2(chunk) steps makes (and keeps for the backward).
SCAN_CHUNK = 512


def init_ssm(cfg, gen: torch.Generator, n_layers: int, device,
             dtype: Optional[torch.dtype] = None) -> Params:
    """``dtype``: of the in, gate and out matrices (the compute dtype by
    default); the dt, B, C projections, A and the skip stay fp32."""
    d, H, D, N = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.ssm_state
    inner = H * D
    L = (n_layers,) if n_layers else ()
    dt = dtype or compute_dtype(cfg)
    f32 = torch.float32
    # A initialised to -[1..N] per channel (S4D-real style), stored as
    # log(-A)
    a = torch.arange(1, N + 1, dtype=f32, device=device).expand(
        L + (inner, N))
    return {
        "w_in": _normal(gen, L + (d, inner), d ** -0.5, dt, device),
        "w_gate": _normal(gen, L + (d, inner), d ** -0.5, dt, device),
        "w_dt": _normal(gen, L + (inner, inner), inner ** -0.5, f32, device),
        "dt_bias": torch.zeros(L + (inner,), dtype=f32, device=device),
        "w_b": _normal(gen, L + (inner, N), inner ** -0.5, f32, device),
        "w_c": _normal(gen, L + (inner, N), inner ** -0.5, f32, device),
        "a_log": torch.log(a).contiguous(),
        "d_skip": torch.ones(L + (inner,), dtype=f32, device=device),
        "w_out": _normal(gen, L + (inner, d), inner ** -0.5, dt, device),
    }


def _scan_chunk(decay: torch.Tensor, inp: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
    """Every state of one chunk: h_t = decay_t * h_{t-1} + inp_t from
    ``h`` (B, I, N), decay and inp (B, c, I, N).  Step k adds to each
    token the state 2^k tokens back, weighted by the product of the
    decays between them (which doubles its span)."""
    c = decay.shape[1]
    hs = torch.cat([torch.addcmul(inp[:, :1], decay[:, :1], h[:, None]),
                    inp[:, 1:]], 1)
    k = 1
    while k < c:
        hs = torch.cat([hs[:, :k],
                        torch.addcmul(hs[:, k:], decay[:, k:], hs[:, :-k])],
                       1)
        if 2 * k < c:
            decay = torch.cat([decay[:, :k], decay[:, k:] * decay[:, :-k]],
                              1)
        k *= 2
    return hs


def selective_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor,
                   state0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u/dt: (B, S, I); A: (I, N); Bm/Cm: (B, S, N); state0: (B, I, N).

    The JAX scan's ``block`` (``cfg.ssm_block``, tokens a scan step)
    changes no value there, so the port has none.  Returns (y (B, S, I),
    final_state (B, I, N)), fp32."""
    B, S, I = u.shape
    N = A.shape[-1]
    u, dt, Bm, Cm = u.float(), dt.float(), Bm.float(), Cm.float()
    h = (state0.float() if state0 is not None else
         torch.zeros((B, I, N), dtype=torch.float32, device=u.device))
    ys = []
    for s0 in range(0, S, SCAN_CHUNK):
        s1 = min(S, s0 + SCAN_CHUNK)
        decay = torch.exp(dt[:, s0:s1, :, None] * A)           # (B, c, I, N)
        inp = (dt[:, s0:s1] * u[:, s0:s1])[..., None] \
            * Bm[:, s0:s1, None, :]
        hs = _scan_chunk(decay, inp, h)
        h = hs[:, -1]
        ys.append(torch.einsum("bcin,bcn->bci", hs, Cm[:, s0:s1]))
    return torch.cat(ys, 1), h


def apply_ssm(p: Params, x: torch.Tensor, cfg, *,
              state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, d).  ``state`` (decode, prefill into a cache): this
    layer's (B, I, N) fp32 state, read as the initial state and then
    overwritten IN PLACE with the final one (the JAX package returns it).
    Returns (output (B, S, d), the state or None)."""
    u = (x @ p["w_in"].to(x.dtype)).float()                   # (B, S, I)
    gate = F.silu(x @ p["w_gate"].to(x.dtype))
    dt = F.softplus(u @ p["w_dt"] + p["dt_bias"])
    Bm = u @ p["w_b"]
    Cm = u @ p["w_c"]
    A = -torch.exp(p["a_log"])
    y, h = selective_scan(u, dt, A, Bm, Cm, state)
    y = y + p["d_skip"] * u
    out = (y.to(x.dtype) * gate) @ p["w_out"].to(x.dtype)
    if state is None:
        return out, None
    state.copy_(h)
    return out, state


def init_ssm_state(cfg, batch: int, device) -> torch.Tensor:
    """The stacked (L, B, I, N) fp32 decode state, zeros."""
    return torch.zeros((cfg.n_layers, batch, cfg.n_heads * cfg.head_dim,
                        cfg.ssm_state), dtype=torch.float32, device=device)
