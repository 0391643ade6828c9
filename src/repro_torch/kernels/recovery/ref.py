"""Plain PyTorch version of the CATopt recovery / basis-risk fitness: the
counterpart of ``repro/kernels/recovery/ref.py``.  The CPU path runs it,
and it is the oracle the CUDA kernel is held to on the card."""
from __future__ import annotations

import torch

PENALTY_WEIGHT = 10.0


def recovery(il: torch.Tensor, w: torch.Tensor, att, limit) -> torch.Tensor:
    """il: (E, m); w: (..., m) -> (..., E)."""
    return torch.clamp(torch.matmul(w, il.mT) - att, 0.0, limit)


def fitness_sq(il: torch.Tensor, w: torch.Tensor, target: torch.Tensor,
               att, limit) -> torch.Tensor:
    """Sum over events of the squared recovery error: what the kernel
    computes.  il: (E, m); w: (P, m); target: (E,) -> (P,)."""
    return torch.square(recovery(il, w, att, limit) - target).sum(dim=-1)


def basis_risk(il: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
               att, limit, budget) -> torch.Tensor:
    """RMSE(recovery - target) + budget-constraint penalty.  (..., m)->(...)."""
    rec = recovery(il, w, att, limit)
    mse = torch.square(rec - target).mean(dim=-1)
    over = torch.clamp(w.sum(dim=-1) - budget, min=0.0)
    return torch.sqrt(mse) + PENALTY_WEIGHT * torch.square(over)
