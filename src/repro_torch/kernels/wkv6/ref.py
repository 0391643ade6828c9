"""Plain PyTorch version of the RWKV-6 recurrence: the counterpart of
``repro/kernels/wkv6/ref.py``.  It re-exports the model's exact scan, so the
kernel is held to the single source of truth.  The CPU path runs it, and it
is the oracle the CUDA kernel is held to on the card."""
from __future__ import annotations

import torch

from repro_torch.models.rwkv6 import wkv_scan  # noqa: F401


def wkv(r, k, v, w, u, state0=None) -> torch.Tensor:
    """r/k/v/w: (B, S, H, D); u: (H, D) -> (B, S, H, D) fp32."""
    out, _ = wkv_scan(r, k, v, w, u, state0)
    return out
