"""Learning-rate schedule and gradient clipping: the counterpart of
``repro/optim/schedule.py``.  Both compute in fp32 tensors, as the JAX
package does, and never synchronise with the device."""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.tree import flatten, unflatten


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[Any], torch.Tensor]:
    """Linear warmup over ``warmup`` steps, then a cosine from ``base_lr``
    down to 0.1 x ``base_lr`` at ``total``.  ``lr(step)`` takes an int or
    a tensor and returns a 0-d fp32 tensor (on the step's device)."""
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = base_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, base_lr * (0.1 + 0.9 * cos))
    return lr


def clip_by_global_norm(grads: Dict[str, Any], max_norm: float
                        ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / norm)``.  Returns (new
    grads in their dtypes, the global norm before clipping, fp32)."""
    leaves, treedef = flatten(grads)
    sq = sum(torch.sum(torch.square(g.float())) for g in leaves)
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return unflatten(treedef, [(g.float() * scale).to(g.dtype)
                               for g in leaves]), norm
