"""Op boundary for flash attention: the counterpart of
``repro/kernels/flash_attention/ops.py``, in the model's (B, S, H, D)
layout with GQA.

    attention(q, k, v, ...)             forward only (no lse)
    attention_trainable(q, k, v, ...)   differentiable: forward with lse,
                                        backward kernels

The backend follows the tensors' device and nothing else: CPU tensors run
the plain versions (``ref.py``), CUDA tensors the hand-written kernels
(``kernel.py``), which raise for anything they do not take.

``attention_trainable`` is a ``torch.autograd.Function`` (``_Flash``), as
``attention_vjp`` is a ``jax.custom_vjp``: its forward runs the kernel that
also writes lse and saves (q, k, v, o, lse); its backward computes
``dsum = sum(do * o, -1)`` in torch, as the JAX wrapper does outside the
kernel, then the dq and dk/dv kernels.  The dk/dv kernel sums over the
query heads of each KV head itself, so no group-sum follows here.  When no
gradient is wanted (``torch.no_grad()``, or no input that requires one),
``attention_trainable`` runs the forward without lse instead: the same
output, without the residuals.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B*H, S, D), contiguous (at B 1 the reshape alone
    can return a strided view)."""
    B, S, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, S, D).contiguous()


def _unflat(x: torch.Tensor, B: int) -> torch.Tensor:
    """(B*H, S, D) -> (B, S, H, D), a view."""
    BH, S, D = x.shape
    return x.reshape(B, BH // B, S, D).transpose(1, 2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, H, D).  Window 0
    = unlimited."""
    out = _kernel.flash_fwd(_flat(q), _flat(k), _flat(v),
                            n_q_heads=q.shape[2], causal=causal,
                            window=window, softcap=softcap)
    return _unflat(out, q.shape[0])


class _Flash(torch.autograd.Function):
    """Flat layout: q (B*H, Sq, D); k/v (B*Hkv, Sk, D)."""

    @staticmethod
    def forward(ctx, q, k, v, n_q_heads, causal, window, softcap):
        o, lse = _kernel.flash_fwd(q, k, v, n_q_heads=n_q_heads,
                                   causal=causal, window=window,
                                   softcap=softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(n_q_heads=n_q_heads, causal=causal, window=window,
                        softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dsum = (do.float() * o.float()).sum(dim=-1)
        dq, dk, dv = _kernel.flash_bwd(q, k, v, do, lse, dsum, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def attention_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """(B, S, H, D) API over the differentiable kernel pair."""
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return attention(q, k, v, causal=causal, window=window,
                         softcap=softcap)
    out = _Flash.apply(_flat(q), _flat(k), _flat(v), q.shape[2], causal,
                       window, softcap)
    return _unflat(out, q.shape[0])
