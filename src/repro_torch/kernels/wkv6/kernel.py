"""CUDA RWKV-6 recurrence for Hopper: the port of
``repro/kernels/wkv6/kernel.py::wkv_pallas``.

The kernel (``csrc/wkv6.cu``, whose header note gives the design) computes,
per (batch row b, head h), ``out_t = r_t . S + (r_t . (u * k_t)) v_t`` and
then ``S <- diag(w_t) S + k_t v_t^T``, with the D x D fp32 state in
registers from the first token to the last.  It reads r, k, v and w in the
model's (B, S, H, D) layout by stride (no transposed copies) and writes the
output in r's dtype, contiguous.  This module is its ctypes wrapper.  The
plain version is ``ref.wkv``: the wrapper runs it for CPU tensors, and only
for them; for CUDA tensors it launches the kernel or raises.

``launches`` counts wrapper calls that launched the kernel (none for the
plain version), so a run can show that its main path went through the
kernel.  The caller resets and reads it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6 import ref as _ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BLOCKS = 2 ** 31 - 1        # B*H rides on the grid's x extent

launches = 0

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        lib = _build.library("wkv6")
        fn = lib.wkv6_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.wkv6_error_string.argtypes = [ctypes.c_int]
        lib.wkv6_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.wkv6_error_string)
    return _fn


def _check(r, k, v, w, u):
    """What the CUDA kernel takes; raises for anything else."""
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, D), got {tuple(r.shape)}")
    B, S, H, D = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, r "
                             f"{tuple(r.shape)}")
    if u.shape != (H, D):
        raise ValueError(f"u must be ({H}, {D}), got {tuple(u.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes "
                            f"float32 or bfloat16")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k and v must share a dtype, got {r.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one the kernel is built "
                         f"for: {HEAD_DIMS}")
    if B * H > MAX_BLOCKS or S >= 2 ** 31:
        raise ValueError(f"B*H = {B * H} or S = {S} beyond the grid")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The RWKV-6 recurrence from a zero state, with no final state out.

    r/k/v (B, S, H, D) in one dtype (float32 or bfloat16), w (B, S, H, D)
    float32 or bfloat16, u (H, D); each with a contiguous last axis, any
    other strides.  Returns (B, S, H, D) in r's dtype, contiguous.  Never
    synchronises with the host.
    """
    global launches
    if r.device.type == "cpu":
        if any(t.device != r.device for t in (k, v, w, u)):
            raise ValueError("r, k, v, w and u must share a device")
        return _ref.wkv(r, k, v, w, u).to(r.dtype)
    if r.device.type != "cuda":
        raise ValueError(f"no kernel for device {r.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        raise RuntimeError("the wkv6 kernel has no gradient (nor has the "
                           "TPU kernel it ports); call it under "
                           "torch.no_grad()")
    _check(r, k, v, w, u)
    B, S, H, D = r.shape
    out = torch.empty((B, S, H, D), dtype=r.dtype, device=r.device)
    if out.numel() == 0:
        return out
    uf = u.to(torch.float32).contiguous()
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (r, k, v, w) for s in t.stride()[:3]])
    fn, errstr = _kernel_fn()
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             uf.data_ptr(), out.data_ptr(), B, S, H, D, DTYPES[r.dtype],
             DTYPES[w.dtype], strides,
             torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6 launch failed: {errstr(err).decode()} "
                           f"({err})")
    launches += 1
    return out
