"""CUDA paged-attention kernel for Hopper: the port of
``repro/kernels/paged_attention/kernel.py::paged_attention_update_pallas``.

The kernel (``csrc/paged_attention.cu``, whose header note gives the
design) scatters the step's fresh K/V rows into their pages and walks each
request's block table with online softmax, in one launch.  This module is
its ctypes wrapper.  The plain version is
``ref.unified_attention_update``: the wrapper runs it for CPU tensors, and
only for them; for CUDA tensors it launches the kernel or raises.

``launches`` counts kernel launches (one per wrapper call on CUDA tensors,
none for the plain version), so a run can show that its main path went
through the kernel.  The caller resets and reads it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import ref as _ref

HEAD_DIMS = (16, 64, 256)
MAX_BLOCK_SIZE = 64          # shared memory: (16 + 2*BS) * (D + 1) fp32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        lib = _build.library("paged_attention")
        fn = lib.paged_attention_update
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.paged_attention_error_string)
    return _fn


def _check(q, k_new, v_new, k_pool, v_pool, block_tables, positions):
    B, S, H, D = q.shape
    NB, BS, Hkv, Dp = k_pool.shape
    tensors = {"q": q, "k_new": k_new, "v_new": v_new, "k_pool": k_pool,
               "v_pool": v_pool, "block_tables": block_tables,
               "positions": positions}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    for name in ("k_new", "v_new", "k_pool", "v_pool"):
        if tensors[name].dtype != q.dtype:
            raise TypeError(f"{name} is {tensors[name].dtype}, q {q.dtype}")
    for name in ("block_tables", "positions"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if Dp != D or v_pool.shape != k_pool.shape or H % Hkv:
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if k_new.shape != (B, S, Hkv, D) or v_new.shape != k_new.shape:
        raise ValueError(f"k_new/v_new must be {(B, S, Hkv, D)}")
    if positions.shape != (B, S) or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise ValueError("positions must be (B, S), block_tables (B, MB)")
    if not 1 <= BS <= MAX_BLOCK_SIZE:
        raise ValueError(f"block_size {BS} not in [1, {MAX_BLOCK_SIZE}]")
    for name in ("q", "k_new", "v_new", "k_pool", "v_pool"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(the kernel moves 16-byte vectors)")


def paged_attention_update(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           positions: torch.Tensor, *, window: int,
                           softcap: float, max_live_blocks: int):
    """Scatter this step's fresh K/V rows, then attend over the pages.

    q (B, S, H, D); k_new/v_new (B, S, Hkv, D); pools (NB, BS, Hkv, D),
    all one dtype (fp32 or bf16), D in ``HEAD_DIMS``; block_tables
    (B, MB) and positions (B, S) int32, -1 marking padded rows.  The walk
    covers at most ``max_live_blocks`` logical blocks per request.  Returns
    (out (B, S, H, D), k_pool, v_pool); the pools are updated in place.
    Never synchronises with the host.
    """
    global launches
    if q.device.type == "cpu":
        return _ref.unified_attention_update(
            q, k_new, v_new, k_pool, v_pool, block_tables, positions,
            window=window, softcap=softcap, max_live_blocks=max_live_blocks)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k_new, v_new, k_pool, v_pool, block_tables, positions)
    B, S, H, D = q.shape
    NB, BS, Hkv, _ = k_pool.shape
    MB = block_tables.shape[1]
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out, k_pool, v_pool
    fn, errstr = _kernel_fn()
    err = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
             k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
             positions.data_ptr(), out.data_ptr(), B, S, H, Hkv, D, BS, MB,
             max(1, min(int(max_live_blocks), MB)), int(window),
             D ** -0.5, float(softcap), _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention_update launch failed: "
                           f"{errstr(err).decode()} ({err})")
    launches += 1
    return out, k_pool, v_pool
