"""CUDA flash-attention kernels for Hopper: the ports of
``repro/kernels/flash_attention/kernel.py``:

  * ``flash_attention_pallas`` -> :func:`flash_fwd` (``with_lse=False``);
  * ``flash_attention_fwd_lse`` -> :func:`flash_fwd` (``with_lse=True``);
  * ``flash_attention_bwd`` -> :func:`flash_bwd` (a dq kernel and a dk/dv
    kernel, the TPU kernel's two ``pallas_call``\\ s).

The forward is one kernel with a compile-time switch for lse
(``csrc/flash_attention.cu``, whose header note gives the design); in
bf16 every kernel runs on the tensor cores (``csrc/flash_mma.cuh``), in
fp32 as scalar FMA.  The backward's dk/dv kernel loops over the G query
heads of each KV head and writes per-KV-head dk and dv, where the TPU
kernel writes them per query head for ``ops.py`` to group-sum.  This
module is their ctypes wrappers.
The plain versions are in ``ref.py`` (``flash_bwd`` followed by
``group_sum`` for the backward): a wrapper runs its plain version for CPU
tensors, and only for them; for CUDA tensors it launches the kernel or
raises.

Launch counts, one per kernel (a wrapper adds one where it launches, none
for the plain version), so a run can show that its path went through the
kernels; the caller resets and reads them:

    fwd_launches      the forward without lse (row 4 of PERF.md's table)
    fwd_lse_launches  the forward with lse (row 5)
    dq_launches       the backward's dq kernel (row 6)
    dkv_launches      the backward's dk/dv kernel (row 6)
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref as _ref

MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_Y = 65535          # B*H (and B*Hkv) ride on the grid's y extent

fwd_launches = 0
fwd_lse_launches = 0
dq_launches = 0
dkv_launches = 0

_fns: Dict[str, object] = {}


def _lib():
    if not _fns:
        lib = _build.library("flash_attention")
        fwd = lib.flash_fwd_launch
        fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                        + [ctypes.c_float] * 2 + [ctypes.c_int,
                                                  ctypes.c_void_p])
        dq = lib.flash_bwd_dq_launch
        dq.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2 + [ctypes.c_int,
                                                 ctypes.c_void_p])
        dkv = lib.flash_bwd_dkv_launch
        dkv.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                        + [ctypes.c_float] * 2 + [ctypes.c_int,
                                                  ctypes.c_void_p])
        for fn in (fwd, dq, dkv):
            fn.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
        lib.flash_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.flash_smem_bytes.restype = ctypes.c_int
        _fns.update(fwd=fwd, dq=dq, dkv=dkv, err=lib.flash_error_string,
                    smem=lib.flash_smem_bytes)
    return _fns


def _raise_on(err: int, what: str) -> None:
    if err:
        msg = _lib()["err"](err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def _check(q, k, v, n_q_heads, **rows):
    """What the CUDA kernels take; raises for anything else.  ``rows``:
    further (B*H, Sq, D) tensors in q's dtype (do) and (B*H, Sq) fp32
    ones (lse, dsum)."""
    tensors = {"q": q, "k": k, "v": v, **rows}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in DTYPES:
        raise TypeError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"q must be (B*H, Sq, D), k and v (B*Hkv, Sk, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, Sq, D = q.shape
    H = n_q_heads
    if H <= 0 or BH % H or k.shape[2] != D:
        raise ValueError(f"q {tuple(q.shape)} is not B*{H} query heads of "
                         f"k's head dim {k.shape[2]}")
    B = BH // H
    if B == 0 or k.shape[0] % B or H % (k.shape[0] // B):
        raise ValueError(f"k rows {k.shape[0]} are not B*Hkv with Hkv "
                         f"dividing {H}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} not in [1, {MAX_HEAD_DIM}]")
    if BH > MAX_GRID_Y:
        raise ValueError(f"B*H {BH} beyond the grid's {MAX_GRID_Y}")
    for name, t in rows.items():
        if name == "do":
            if t.dtype != q.dtype or t.shape != q.shape:
                raise TypeError(f"do must be {q.dtype} {tuple(q.shape)}")
        elif t.dtype != torch.float32 or t.shape != (BH, Sq):
            raise TypeError(f"{name} must be float32 {(BH, Sq)}")
    for name in ("k", "v"):
        if tensors[name].dtype != q.dtype:
            raise TypeError(f"{name} is {tensors[name].dtype}, q {q.dtype}")


def smem_bytes(kernel: str, dtype: torch.dtype, head_dim: int) -> int:
    """Dynamic shared memory that a launch of ``kernel`` ("fwd", "dq" or
    "dkv") asks for at ``head_dim`` and ``dtype``."""
    n = _lib()["smem"](("fwd", "dq", "dkv").index(kernel), DTYPES[dtype],
                       head_dim)
    if n < 0:
        raise ValueError(f"no {kernel} kernel for {dtype} at D {head_dim}")
    return n


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              n_q_heads: int, causal: bool = True, window: int = 0,
              softcap: float = 0.0, with_lse: bool = False
              ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Flash-attention forward.  q (B*H, Sq, D), k/v (B*Hkv, Sk, D), one
    dtype (fp32 or bf16), contiguous, D <= 256; window 0 = none.  Returns
    o (B*H, Sq, D), and with ``with_lse`` also lse (B*H, Sq) fp32.  Never
    synchronises with the host."""
    global fwd_launches, fwd_lse_launches
    if q.device.type == "cpu":
        return _ref.flash_fwd(q, k, v, n_q_heads=n_q_heads, causal=causal,
                              window=window, softcap=softcap,
                              with_lse=with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, n_q_heads)
    BH, Sq, D = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.numel() and k.shape[1]:
        err = _lib()["fwd"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), BH, n_q_heads,
            k.shape[0] // (BH // n_q_heads), Sq, k.shape[1], D, int(causal),
            int(window), D ** -0.5, float(softcap), DTYPES[q.dtype],
            _stream(q))
        _raise_on(err, "flash attention forward")
        if with_lse:
            fwd_lse_launches += 1
        else:
            fwd_launches += 1
    return (o, lse) if with_lse else o


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, lse: torch.Tensor, dsum: torch.Tensor, *,
              n_q_heads: int, causal: bool = True, window: int = 0,
              softcap: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward from the forward's lse and
    ``dsum = sum(do * o, -1)`` (fp32, (B*H, Sq)).  Shapes and types as
    :func:`flash_fwd`, do like q.  Returns (dq (B*H, Sq, D), dk and dv per
    KV head (B*Hkv, Sk, D)), in q's dtype.  Never synchronises with the
    host."""
    global dq_launches, dkv_launches
    if q.device.type == "cpu":
        dq, dk_h, dv_h = _ref.flash_bwd(
            q, k, v, do, lse, dsum, n_q_heads=n_q_heads, causal=causal,
            window=window, softcap=softcap)
        return (dq, _ref.group_sum(dk_h, n_q_heads, k.shape[0]),
                _ref.group_sum(dv_h, n_q_heads, k.shape[0]))
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, n_q_heads, do=do, lse=lse, dsum=dsum)
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    Hkv = k.shape[0] // (BH // n_q_heads)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0 or Sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    args = (BH, n_q_heads, Hkv, Sq, Sk, D, int(causal), int(window),
            D ** -0.5, float(softcap), DTYPES[q.dtype], _stream(q))
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), dsum.data_ptr())
    _raise_on(_lib()["dq"](*ins, dq.data_ptr(), *args),
              "flash attention dq")
    dq_launches += 1
    _raise_on(_lib()["dkv"](*ins, dk.data_ptr(), dv.data_ptr(), *args),
              "flash attention dk/dv")
    dkv_launches += 1
    return dq, dk, dv
