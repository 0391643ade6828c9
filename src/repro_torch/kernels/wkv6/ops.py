"""Op boundary for the RWKV-6 recurrence: the counterpart of
``repro/kernels/wkv6/ops.py``, in the model's (B, S, H, D) layout.

The backend follows the tensors' device and nothing else: CPU tensors run
the plain version (``ref.wkv``), CUDA tensors the hand-written kernel
(``kernel.wkv6``), which raises for anything it does not take.  The result
is in ``r``'s dtype, as the JAX op casts it.  The kernel has no gradient,
as the TPU kernel has none: on CUDA tensors, while a gradient is being
recorded for any input, the op raises rather than run the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wkv6 import kernel as _kernel


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """r/k/v/w: (B, S, H, D); u: (H, D) -> (B, S, H, D) in r's dtype.

    ``chunk`` is the TPU kernel's tokens per grid step, a tiling parameter
    of that machine; it is taken for the JAX op's signature and changes
    nothing here."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return _kernel.wkv6(r, k, v, w, u)
