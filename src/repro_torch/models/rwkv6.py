"""RWKV-6 "Finch" blocks: time-mix with data-dependent decay + channel-mix.
The counterpart of ``repro/models/rwkv6.py``.

Recurrence per head (state S in R^{D x D}, token t):
    out_t = r_t . S_{t-1} + (r_t . (u * k_t)) v_t
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(w0 + tanh(xw @ A) @ B)) a *data-dependent* per-channel
decay.  ``wkv_scan`` is the exact recurrence, a loop over tokens; with
``cfg.use_pallas_wkv`` and no carried state, ``apply_time_mix`` runs the
op ``kernels/wkv6/ops.wkv`` instead (the CUDA kernel on the card), where
the JAX package runs its Pallas kernel.

The token-shift coefficients ``mu``, the decay's ``w0``, ``w1``, ``w2`` and
the bonus ``u`` are fp32 whatever the matrices' dtype, as in the JAX
package: the decay is computed in fp32.  A decode state is
``{"shift": (B, 1, d), "wkv": (B, H, D, D) fp32}`` for the time mix and
``{"shift": (B, 1, d)}`` for the channel mix; the layer returns the new
one, and ``transformer.apply_stack`` writes it into the stacked cache.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal, apply_norm, compute_dtype

Params = Dict[str, Any]

DECAY_LORA = 64


def init_time_mix(cfg, gen: torch.Generator, n_layers: int, device,
                  dtype: Optional[torch.dtype] = None) -> Params:
    """``dtype``: of the matrices, the compute dtype by default."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    inner = H * hd
    L = (n_layers,) if n_layers else ()
    dt = dtype or compute_dtype(cfg)
    f32 = torch.float32

    def full(shape, value):
        return torch.full(shape, value, dtype=f32, device=device)

    return {
        # token-shift lerp coefficients for r/k/v/w/g
        "mu": full(L + (5, d), 0.5),
        "wr": _normal(gen, L + (d, inner), d ** -0.5, dt, device),
        "wk": _normal(gen, L + (d, inner), d ** -0.5, dt, device),
        "wv": _normal(gen, L + (d, inner), d ** -0.5, dt, device),
        "wg": _normal(gen, L + (d, inner), d ** -0.5, dt, device),
        # data-dependent decay LoRA
        "w0": full(L + (inner,), -4.0),
        "w1": _normal(gen, L + (d, DECAY_LORA), d ** -0.5, f32, device),
        "w2": _normal(gen, L + (DECAY_LORA, inner), DECAY_LORA ** -0.5, f32,
                      device),
        # per-head bonus
        "u": full(L + (H, hd), 0.0),
        # grouped output norm + projection
        "ln_out": {"scale": full(L + (inner,), 1.0),
                   "bias": full(L + (inner,), 0.0)},
        "wo": _normal(gen, L + (inner, d), inner ** -0.5, dt, device),
    }


def init_channel_mix(cfg, gen: torch.Generator, n_layers: int, device,
                     dtype: Optional[torch.dtype] = None) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    L = (n_layers,) if n_layers else ()
    dt = dtype or compute_dtype(cfg)
    return {
        "mu": torch.full(L + (2, d), 0.5, dtype=torch.float32,
                         device=device),
        "wk": _normal(gen, L + (d, f), d ** -0.5, dt, device),
        "wv": _normal(gen, L + (f, d), f ** -0.5, dt, device),
    }


def init_rwkv_state(cfg, batch: int, dtype=None, device=None) -> Params:
    """Constant-size decode state (the reason rwkv runs long_500k): the
    shifts in ``dtype`` (the compute dtype by default), the wkv state fp32."""
    H, D, d, L = cfg.n_heads, cfg.head_dim, cfg.d_model, cfg.n_layers
    dt = dtype or compute_dtype(cfg)
    return {
        "tm_shift": torch.zeros((L, batch, 1, d), dtype=dt, device=device),
        "wkv": torch.zeros((L, batch, H, D, D), dtype=torch.float32,
                           device=device),
        "cm_shift": torch.zeros((L, batch, 1, d), dtype=dt, device=device),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """x: (B, S, d) -> previous token's x (zero/state for the first)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _mix_inputs(p: Params, x: torch.Tensor, x_prev: torch.Tensor
                ) -> List[torch.Tensor]:
    mu = p["mu"].to(x.dtype)  # (5, d)
    mixed = x[:, :, None, :] + (x_prev - x)[:, :, None, :] * mu  # (B,S,5,d)
    return list(mixed.unbind(2))


def wkv_scan(r, k, v, w, u, state0=None, block: int = 1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact recurrence.  r/k/v/w: (B, S, H, D); u: (H, D); state0:
    (B, H, D, D) or None (zeros).  Returns (out (B, S, H, D) fp32, final
    state (B, H, D, D) fp32).

    One step per token, in fp32, in the JAX scan's order of operations:
    ``out = r . S + (r . (u*k)) v`` from the state before the update, then
    ``S <- S * w[:, None] + k v^T``.  The bonus term needs no state, so it
    is computed for every token at once and added after the loop.
    ``block`` is the JAX scan's tokens per scan step, an exact regrouping
    there; a Python loop has nothing to regroup, so it changes nothing.
    """
    B, S, H, D = r.shape
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    r, k, v, w = (x.float() for x in (r, k, v, w))
    st = (torch.zeros((B * H, D, D), dtype=torch.float32, device=r.device)
          if state0 is None else state0.float().reshape(B * H, D, D))
    # (S, B*H, D): one contiguous (B*H, D) slice per token
    R, K, V, W = (x.transpose(0, 1).reshape(S, B * H, D)
                  for x in (r, k, v, w))
    rs = []
    for t in range(S):
        rs.append(torch.bmm(R[t][:, None], st))               # r . S_{t-1}
        st = torch.addcmul(st * W[t][:, :, None], K[t][:, :, None],
                           V[t][:, None, :])
    if S:
        rS = torch.stack(rs).reshape(S, B, H, D).transpose(0, 1)
    else:
        rS = torch.zeros_like(r)
    bonus = (r * (u.float()[None, None] * k)).sum(-1)          # (B, S, H)
    return rS + bonus[..., None] * v, st.reshape(B, H, D, D)


def time_mix_inputs(p: Params, x: torch.Tensor, cfg,
                    prev: Optional[torch.Tensor] = None):
    """The recurrence's inputs and the output gate of one time mix.
    x: (B, S, d), normed; prev: the previous token's x (B, 1, d) or None.
    Returns r, k, v (B, S, H, D) in x's dtype, w (B, S, H, D) fp32, and
    g (B, S, H*D)."""
    B, S, _ = x.shape
    H, D = cfg.n_heads, cfg.head_dim
    dt = x.dtype
    xr, xk, xv, xw, xg = _mix_inputs(p, x, _token_shift(x, prev))
    r = (xr @ p["wr"].to(dt)).reshape(B, S, H, D)
    k = (xk @ p["wk"].to(dt)).reshape(B, S, H, D)
    v = (xv @ p["wv"].to(dt)).reshape(B, S, H, D)
    g = F.silu(xg @ p["wg"].to(dt))
    dd = torch.tanh(xw.float() @ p["w1"].float()) @ p["w2"].float()
    w = torch.exp(-torch.exp(p["w0"].float() + dd)).reshape(B, S, H, D)
    return r, k, v, w, g


def apply_time_mix(p: Params, x: torch.Tensor, cfg, *,
                   state: Optional[Params] = None
                   ) -> Tuple[torch.Tensor, Optional[Params]]:
    """state (decode): {"shift": (B,1,d), "wkv": (B,H,D,D)}.  Returns
    (output, new state or None)."""
    B, S, _ = x.shape
    prev = state["shift"] if state is not None else None
    r, k, v, w, g = time_mix_inputs(p, x, cfg, prev)
    if cfg.use_pallas_wkv and state is None:
        from repro_torch.kernels.wkv6 import ops as wkv_ops
        out = wkv_ops.wkv(r, k, v, w, p["u"])      # in r's dtype
        s_final = None
    else:
        s0 = state["wkv"] if state is not None else None
        out, s_final = wkv_scan(r, k, v, w, p["u"], s0, block=cfg.wkv_block)
    out = apply_norm(p["ln_out"], out.reshape(B, S, -1))
    out = (out.to(x.dtype) * g) @ p["wo"].to(x.dtype)
    new_state = None
    if state is not None:
        new_state = {"shift": x[:, -1:], "wkv": s_final}
    return out, new_state


def apply_channel_mix(p: Params, x: torch.Tensor, cfg, *,
                      state: Optional[Params] = None
                      ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Squared-ReLU channel mix; only ``mu[0]`` is used and there is no
    receptance gate, as in the JAX package."""
    prev = state["shift"] if state is not None else None
    x_prev = _token_shift(x, prev)
    dt = x.dtype
    xk = x + (x_prev - x) * p["mu"][0].to(dt)
    k = torch.square(torch.relu(xk @ p["wk"].to(dt)))
    out = k @ p["wv"].to(dt)
    new_state = {"shift": x[:, -1:]} if state is not None else None
    return out, new_state
