"""CUDA RWKV-6 recurrence for Hopper: the port of
``repro/kernels/wkv6/kernel.py::wkv_pallas``.

The kernel (``csrc/wkv6.cu``, whose header note gives the design) computes,
per (batch row b, head h), ``out_t = r_t . S + (r_t . (u * k_t)) v_t`` and
then ``S <- diag(w_t) S + k_t v_t^T``, with the D x D fp32 state in
registers from the first token to the last, split over
``D / BLOCK_COLUMNS`` blocks a head (:func:`wkv_plan`).  It reads r, k,
v and w in the model's (B, S, H, D) layout by stride (no transposed
copies; a tensor whose rows do not start on 16-byte boundaries is copied
first) and writes the output in r's dtype, contiguous.  This module is its
ctypes wrapper.  The
plain version is ``ref.wkv``: the wrapper runs it for CPU tensors, and only
for them; for CUDA tensors it launches the kernel or raises.

``launches`` counts wrapper calls that launched the kernel (none for the
plain version), so a run can show that its main path went through the
kernel.  The caller resets and reads it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6 import ref as _ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BLOCKS = 2 ** 31 - 1        # B*H*D/columns rides on the grid's x extent
BLOCK_COLUMNS = 16              # columns of a head's state a block owns
COLS_PER_LANE = 2               # state columns a lane keeps: Tile::kCols

launches = 0

_fn = None


def rows_per_lane(D: int) -> int:
    """State rows of one column a lane keeps: ``Tile<D>::kRows``."""
    return 8 if D >= 128 else 4


class WkvPlan(NamedTuple):
    """One call: ``blocks`` on the grid (each owning ``columns`` columns
    of one (b, h)), ``threads`` a block, ``lanes_per_column``."""
    blocks: int
    threads: int
    columns: int
    lanes_per_column: int


def wkv_plan(B: int, H: int, D: int) -> WkvPlan:
    """How a call of B rows, H heads of head dim D is split."""
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one the kernel is built "
                         f"for: {HEAD_DIMS}")
    lanes = D // rows_per_lane(D)
    return WkvPlan(B * H * (D // BLOCK_COLUMNS),
                   BLOCK_COLUMNS * lanes // COLS_PER_LANE, BLOCK_COLUMNS,
                   lanes)


def _rows_aligned(t: torch.Tensor) -> bool:
    """Each (b, s, h) row of ``t`` starts on a 16-byte boundary."""
    size = t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(st * size % 16 == 0 for st in t.stride()[:3]))


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
        lib.wkv6_block_shape.argtypes = [ctypes.c_int] + [
            ctypes.POINTER(ctypes.c_int)] * 2
        lib.wkv6_block_shape.restype = ctypes.c_int
        for D in HEAD_DIMS:
            cols, threads = ctypes.c_int(), ctypes.c_int()
            lib.wkv6_block_shape(D, ctypes.byref(cols), ctypes.byref(threads))
            plan = wkv_plan(1, 1, D)
            if (cols.value, threads.value) != (plan.columns, plan.threads):
                raise RuntimeError("kernel.py and csrc/wkv6.cu disagree on "
                                   f"the block at head dim {D}")
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
    blocks = wkv_plan(B, H, D).blocks
    if blocks > MAX_BLOCKS or S >= 2 ** 31:
        raise ValueError(f"{blocks} blocks or S = {S} beyond the grid")


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
    r, k, v, w = (t if _rows_aligned(t)
                  else t.clone(memory_format=torch.contiguous_format)
                  for t in (r, k, v, w))
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
