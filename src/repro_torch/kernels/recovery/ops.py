"""Op boundary for the CATopt fitness: the counterpart of
``repro/kernels/recovery/ops.py``.

The backend follows the tensors' device and nothing else: CPU tensors run
the plain version (``ref.fitness_sq``), CUDA tensors the hand-written
kernel (``kernel.py``), which raises for anything it does not take.  There
is no switch that sends CUDA tensors to the plain version, and no padding:
the kernel bounds-checks its edges, so any ``att`` is right (the JAX
boundary pads with zero events, which is right only for ``att >= 0``).

The kernel has a gradient: ``_FitnessSq`` is a ``torch.autograd.Function``
whose backward is the plain product

    d sq / d w = 2 ((rec - target) * 1[0 < loss - att < limit]) @ IL

with ``loss = w @ IL^T`` recomputed by ``torch.matmul``, the products XLA
computes for ``jax.grad`` of the JAX reference.  The sqrt and the budget
penalty stay in torch, as in the JAX boundary, and autograd carries them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.recovery import kernel as _kernel
from repro_torch.kernels.recovery.ref import PENALTY_WEIGHT, recovery  # noqa: F401


class _FitnessSq(torch.autograd.Function):
    """sq (P,) from il (E, m), target (E,), w (P, m); gradient to w only."""

    @staticmethod
    def forward(ctx, il, target, w, att, limit):
        ctx.save_for_backward(il, target, w)
        ctx.att, ctx.limit = att, limit
        return _kernel.fitness_sq(il, w, target, att, limit)

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise NotImplementedError("the fitness gradient flows to w only")
        il, target, w = ctx.saved_tensors
        x = torch.matmul(w, il.mT) - ctx.att
        rec = torch.clamp(x, 0.0, ctx.limit)
        live = (x > 0.0) & (x < ctx.limit)
        d = (2.0 * g)[:, None] * (rec - target) * live
        return None, None, torch.matmul(d, il), None, None


def basis_risk(il: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
               att, limit, budget) -> torch.Tensor:
    """RMSE basis risk + budget penalty.  w: (..., m) -> (...).

    ``att``, ``limit`` and ``budget`` are Python floats (or 0-d tensors,
    read once on the host)."""
    batch_shape = w.shape[:-1]
    m = w.shape[-1]
    wf = w.reshape(-1, m)
    sq = _FitnessSq.apply(il.to(torch.float32).contiguous(),
                          target.to(torch.float32).contiguous(),
                          wf.to(torch.float32).contiguous(), float(att),
                          float(limit))
    mse = sq / il.shape[0]
    over = torch.clamp(wf.sum(dim=-1) - budget, min=0.0)
    out = torch.sqrt(mse) + PENALTY_WEIGHT * torch.square(over)
    return out.reshape(batch_shape)
