"""CUDA fitness kernel for Hopper: the port of
``repro/kernels/recovery/kernel.py::fitness_sq_pallas``.

The kernel (``csrc/fitness.cu``, whose header note gives the design)
computes ``sq[p] = sum_e (clip(IL[e] . w[p] - att, 0, limit) - target[e])^2``
for a whole population: a matrix product with a clip, square and
reduce-over-events epilogue, and a second pass that adds the per-tile
partials in a fixed order.  Populations of at most ``P_NARROW`` rows (the
GA's polish) take a narrow kernel that streams IL once with P dot products
a thread; it gives each row the same sq, bit for bit, as the wide one.
:func:`fitness_plan` says which runs.  This module is their ctypes
wrapper.  The plain
version is ``ref.fitness_sq``: the wrapper runs it for CPU tensors, and
only for them; for CUDA tensors it launches the kernel or raises.

``launches`` counts wrapper calls that launched the kernel (none for the
plain version), so a run can show that its main path went through the
kernel.  The caller resets and reads it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.recovery import ref as _ref

BLOCK_EVENTS = 128           # events per block: kBE in csrc/fitness.cu
BLOCK_INDIVIDUALS = 112      # individuals per wide block: kBP
MAX_P_TILES = 65535          # the grid's y extent, in BLOCK_INDIVIDUALS
P_NARROW = 8                 # P <= 8 takes the narrow kernel (kNarrowP)
RUN_EVENTS = 8               # events a run sums in order: kTM
NARROW_EVENTS = 64           # events per narrow block: kNE

launches = 0

_fn = None


class FitnessPlan(NamedTuple):
    """One call: ``route`` "narrow" or "wide", the first kernel's grid,
    the float32 scratch of partial sums (``workspace`` rows x P: per-run
    sums for the narrow kernel, per-tile sums for the wide one),
    and whether IL and w move in 16-byte copies (else 4-byte ones)."""
    route: str
    grid: Tuple[int, int]
    workspace: Tuple[int, int]
    vec16: bool


def fitness_plan(E: int, m: int, P: int, aligned: bool = True
                 ) -> FitnessPlan:
    """Which kernel a call of E events, m region-perils and P individuals
    takes, and its grid and scratch.  ``aligned``: IL and w start on
    16-byte boundaries."""
    vec16 = bool(aligned and m % 4 == 0)
    if 1 <= P <= P_NARROW:
        return FitnessPlan("narrow", (-(-E // NARROW_EVENTS), 1),
                           (-(-E // RUN_EVENTS), P), vec16)
    return FitnessPlan("wide",
                       (-(-E // BLOCK_EVENTS), -(-P // BLOCK_INDIVIDUALS)),
                       (-(-E // BLOCK_EVENTS), P), vec16)


def _kernel_fn():
    global _fn
    if _fn is None:
        lib = _build.library("fitness")
        fn = lib.fitness_sq
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        lib.fitness_error_string.argtypes = [ctypes.c_int]
        lib.fitness_error_string.restype = ctypes.c_char_p
        narrow = lib.fitness_sq_narrow
        narrow.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float] * 2
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
        narrow.restype = ctypes.c_int
        names = ("fitness_block_events", "fitness_block_individuals",
                 "fitness_narrow_max_p", "fitness_run_events")
        for name in names:
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        if tuple(getattr(lib, name)() for name in names) != (
                BLOCK_EVENTS, BLOCK_INDIVIDUALS, P_NARROW, RUN_EVENTS):
            raise RuntimeError("kernel.py and csrc/fitness.cu disagree on "
                               "the events or individuals per block, the "
                               "run or the narrow P")
        _fn = (fn, narrow, lib.fitness_error_string)
    return _fn


def _check(il, w, target):
    tensors = {"il": il, "w": w, "target": target}
    for name, t in tensors.items():
        if t.device != il.device:
            raise ValueError(f"{name} is on {t.device}, il on {il.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if il.dim() != 2 or w.dim() != 2 or w.shape[1] != il.shape[1]:
        raise ValueError(f"il must be (E, m) and w (P, m), got "
                         f"{tuple(il.shape)} and {tuple(w.shape)}")
    if target.shape != (il.shape[0],):
        raise ValueError(f"target must be ({il.shape[0]},), got "
                         f"{tuple(target.shape)}")
    if (-(-w.shape[0] // BLOCK_INDIVIDUALS) > MAX_P_TILES
            or il.numel() >= 2 ** 31 or w.numel() >= 2 ** 31):
        raise ValueError("population or event count beyond the grid")


def fitness_sq(il: torch.Tensor, w: torch.Tensor, target: torch.Tensor,
               att: float, limit: float) -> torch.Tensor:
    """Sum over events of the squared recovery error of every individual.

    il (E, m), w (P, m), target (E,), all float32 and contiguous on one
    device; att and limit are Python floats.  Returns sq (P,) float32, each
    row's value the same whichever kernel :func:`fitness_plan` picks.
    Never synchronises with the host.
    """
    global launches
    if il.device.type == "cpu":
        return _ref.fitness_sq(il, w, target, att, limit)
    if il.device.type != "cuda":
        raise ValueError(f"no kernel for device {il.device}")
    _check(il, w, target)
    E, m = il.shape
    P = w.shape[0]
    out = torch.empty(P, dtype=torch.float32, device=il.device)
    if P == 0 or E == 0:
        return out.zero_()
    plan = fitness_plan(E, m, P, aligned=il.data_ptr() % 16 == 0
                        and w.data_ptr() % 16 == 0)
    scratch = torch.empty(plan.workspace, dtype=torch.float32,
                          device=il.device)
    wide, narrow, errstr = _kernel_fn()
    stream = torch.cuda.current_stream(il.device).cuda_stream
    if plan.route == "narrow":
        err = narrow(il.data_ptr(), w.data_ptr(), target.data_ptr(),
                     float(att), float(limit), E, m, P, int(plan.vec16),
                     scratch.data_ptr(), out.data_ptr(), stream)
    else:
        err = wide(il.data_ptr(), w.data_ptr(), target.data_ptr(),
                   float(att), float(limit), E, m, P, int(plan.vec16),
                   scratch.data_ptr(), out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"fitness_sq launch failed: "
                           f"{errstr(err).decode()} ({err})")
    launches += 1
    return out
