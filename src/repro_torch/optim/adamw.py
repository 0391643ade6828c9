"""AdamW with a configurable optimizer-state dtype: the counterpart of
``repro/optim/adamw.py``.

State dtypes:
  float32  — standard.
  bfloat16 — halves the states' memory.
  int8     — block-wise symmetric quantisation (one fp32 scale per 128
             values), DESIGN.md §5; the payloads are bit-equal to the JAX
             package's for the same input (``torch.round`` rounds half to
             even, as ``jnp.round``).

Parameters, gradients and states are nested dicts of tensors with the
model's tree; an int8 state leaf is ``{"q": (n, 128) int8, "scale": (n, 1)
fp32}``.  :func:`adamw_update` is functional, as the JAX one: it returns
new tensors and leaves its inputs as they are, so one state can seed
several runs.  It updates a float state leaf in slices of its leading axis
(the update is elementwise, so the values do not depend on the slicing):
then only a slice's temporaries are alive beside the old and the new
state, which is what lets granite-3-2b's fp32 masters, grads and two
states share one 80 GB card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.tree import (flatten, from_paths, get_path, leaf_paths,
                                   tree_map)

BLOCK = 128
SLICE = 1 << 26           # elements per slice of a float state's update


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"   # float32 | bfloat16 | int8


# ---------------------------------------------------------------------------
# Block-wise int8 quantisation
# ---------------------------------------------------------------------------

def quantize_blockwise(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Flatten -> pad to BLOCK -> per-block symmetric int8."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-30)).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_blockwise(qs: Dict[str, torch.Tensor], shape,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    blocks = qs["q"].float() * qs["scale"]
    n = 1
    for s in shape:
        n *= s
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)


def _encode(x: torch.Tensor, state_dtype: str):
    if state_dtype == "int8":
        return quantize_blockwise(x)
    return x.to(getattr(torch, state_dtype))


def _decode(s: Any, shape, state_dtype: str) -> torch.Tensor:
    if state_dtype == "int8":
        return dequantize_blockwise(s, shape)
    return s.float()


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params: Dict[str, Any], opt_cfg: AdamWConfig
               ) -> Dict[str, Any]:
    def zeros():
        return tree_map(lambda p: _encode(torch.zeros_like(
            p, dtype=torch.float32), opt_cfg.state_dtype), params)

    leaves, _ = flatten(params)
    dev = leaves[0].device if leaves else None
    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _step(g, m, v, p, *, lr, c1, c2, opt_cfg: AdamWConfig, decay: bool):
    """One leaf (or slice of one), as the JAX ``upd``: fp32 g, m, v in;
    new p (in p's dtype), m, v (fp32) out."""
    b1, b2 = opt_cfg.b1, opt_cfg.b2
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    step = (m / c1) / (torch.sqrt(v / c2) + opt_cfg.eps)
    pf = p.float()
    if decay:
        step = step + opt_cfg.weight_decay * pf
    return (pf - lr * step).to(p.dtype), m, v


def adamw_update(grads: Dict[str, Any], opt_state: Dict[str, Any],
                 params: Dict[str, Any], lr, opt_cfg: AdamWConfig
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (new_params, new_opt_state); the inputs are not modified.
    ``lr`` is a float or a 0-d fp32 tensor.  Weight decay applies to
    tensors of rank >= 2 only."""
    count = opt_state["count"] + 1
    c1 = 1.0 - opt_cfg.b1 ** count.float()
    c2 = 1.0 - opt_cfg.b2 ** count.float()
    sd = opt_cfg.state_dtype
    paths = list(leaf_paths(params))
    new_p, new_m, new_v = [], [], []
    for path in paths:
        p, g = get_path(params, path), get_path(grads, path)
        m_s, v_s = get_path(opt_state["m"], path), get_path(opt_state["v"], path)
        kw = dict(lr=lr, c1=c1, c2=c2, opt_cfg=opt_cfg, decay=p.dim() >= 2)
        if sd == "int8" or p.dim() == 0:
            np_, m, v = _step(g.float(), _decode(m_s, g.shape, sd),
                              _decode(v_s, g.shape, sd), p, **kw)
            new_p.append(np_)
            new_m.append(_encode(m, sd))
            new_v.append(_encode(v, sd))
            continue
        out_p, out_m, out_v = (torch.empty_like(p), torch.empty_like(m_s),
                               torch.empty_like(v_s))
        rows = max(1, SLICE // max(1, p[0].numel()))
        for r0 in range(0, p.shape[0], rows):
            sl = slice(r0, r0 + rows)
            np_, m, v = _step(g[sl].float(), m_s[sl].float(),
                              v_s[sl].float(), p[sl], **kw)
            out_p[sl] = np_
            out_m[sl] = m
            out_v[sl] = v
        new_p.append(out_p)
        new_m.append(out_m)
        new_v.append(out_v)
    return from_paths(paths, new_p), {"m": from_paths(paths, new_m),
                                  "v": from_paths(paths, new_v), "count": count}
