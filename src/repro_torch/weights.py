"""Weight bridge: the JAX package's parameter tree, as numpy, to the port's.

The port keeps the JAX layout unchanged, so the bridge moves arrays and
transposes nothing: weight matrices stay ``(in, out)`` (``x @ W``), and
layer weights stay stacked on a leading ``L`` axis (the port slices layer
``i`` where JAX scans).  Matrices land in the compute dtype for serving, or
in ``param_dtype`` (fp32 masters for training); norm scales and biases in
fp32 (see ``models/layers.py``), and so are RWKV-6's token-shift
coefficients ``mu``, decay ``w0``, ``w1``, ``w2`` and bonus ``u``, the MoE
router and the SSM's ``w_dt``, ``dt_bias``, ``w_b``, ``w_c``, ``a_log`` and
``d_skip``, which the JAX package keeps fp32 whatever its ``param_dtype``
(``models/rwkv6.py``, ``models/moe.py``, ``models/ssm.py``).

Only the tests build a tree with JAX (``jax.tree.map(np.asarray,
repro.models.model.init_params(cfg, key))``) and hand it over; the port
itself never imports JAX.  On the card, weights come from the port's own
seeded ``models.model.init_params``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import compute_dtype
from repro_torch.models.transformer import check_dense

_FP32_LEAVES = ("scale", "bias", "mu", "w0", "w1", "w2", "u", "router",
                "w_dt", "dt_bias", "w_b", "w_c", "a_log", "d_skip")


def params_from_numpy(tree: Dict[str, Any], cfg, device: DeviceLike = None,
                      param_dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, Any]:
    """Convert a nested dict of numpy arrays into the port's parameters:
    matrices in ``param_dtype`` (the compute dtype by default)."""
    check_dense(cfg)
    dev = resolve_device(device)
    dt = param_dtype or compute_dtype(cfg)

    def conv(node, name):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        arr = np.array(node, dtype=np.float32)      # a writable copy
        return torch.from_numpy(arr).to(
            device=dev, dtype=torch.float32 if name in _FP32_LEAVES else dt)

    return conv(tree, "")


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: fp32 numpy arrays."""
    return {k: params_to_numpy(v) if isinstance(v, dict)
            else v.detach().float().cpu().numpy() for k, v in params.items()}
