"""CUDA paged-attention kernels for Hopper: the ports of the paged-attention
family in ``repro/kernels/paged_attention/kernel.py``:

  * ``paged_attention_update_pallas`` (fp and int8 pools) ->
    :func:`paged_attention_update`: scatter the step's fresh K/V rows into
    their pages and walk each request's block table with online softmax,
    in one launch;
  * ``paged_attention_pallas`` -> :func:`paged_attention`: the same walk,
    read-only;
  * ``copy_page_pallas`` -> :func:`copy_pages`: copy one page over
    another in every layer of up to ``MAX_POOLS`` stacked pools (a
    copy-on-write over the whole cache) in one launch; :func:`copy_page`
    is its one-pool case.

The walks are one kernel (``csrc/paged_attention.cu``, whose header note
gives the design) with two compile-time switches, the scatter (with the
int8 quantize of the fresh rows) and the int8 pools; the copy is
``csrc/copy_page.cu``.  This module is their ctypes wrappers.  The walk
splits each (request, kv head) over its pages: :func:`walk_plan` sizes the
split from host integers alone, and a split walks a fixed run of keys, so a
row's result never depends on the batch around it.  The plain versions
are in ``ref.py``: a wrapper runs its plain version for CPU tensors, and
only for them; for CUDA tensors it launches the kernel or raises.

Launch counts, one per kernel variant the main paths run (a wrapper adds
one where it launches, none for the plain version), so a run can show that
its path went through the kernels; the caller resets and reads them:

    launches           the fused update over fp pools
    int8_launches      the fused update over int8 pools
    readonly_launches  the read-only walk, fp or int8 pools
    copy_launches      copy_pages (and copy_page, its one-pool case)
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import ref as _ref

HEAD_DIMS = (16, 64, 128, 256)
MAX_BLOCK_SIZE = 64          # softmax: a warp's two keys a lane
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # q, out, fp pools
ROWS_PER_TILE = 16           # query rows a block: kRows in the kernel
KEYS_PER_SPLIT = 16          # a split walks max(1, 16 // block_size) pages
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65535
MAX_POOLS = 4                # copy_pages: pools a launch (kMaxPools)


class WalkPlan(NamedTuple):
    """One launch of the walk: ``grid`` (n_tiles * n_split, Hkv, B) blocks
    of ``ROWS_PER_TILE`` query rows and ``pages_per_split`` pages each;
    with ``n_split`` > 1 a float32 workspace of ``workspace`` floats (each
    split's acc, m and l) and ``counters`` int32 counters, zero between
    launches."""
    n_tiles: int
    nb_live: int
    pages_per_split: int
    n_split: int
    grid: Tuple[int, int, int]
    workspace: int
    counters: int


def walk_plan(B: int, S: int, G: int, Hkv: int, D: int, block_size: int,
              max_live_blocks: int, MB: int) -> WalkPlan:
    """The split and the grid of a walk, from host integers only (no device
    sync): the walk covers ``nb_live = clamp(max_live_blocks, 1, MB)``
    logical blocks, ``pages_per_split = max(1, KEYS_PER_SPLIT //
    block_size)`` of them a split, so a split's boundaries depend on the
    block size alone.  Raises ValueError for a grid the card cannot
    launch."""
    nb_live = max(1, min(int(max_live_blocks), int(MB)))
    pps = max(1, KEYS_PER_SPLIT // int(block_size))
    n_split = -(-nb_live // pps)
    n_tiles = -(-(S * G) // ROWS_PER_TILE)
    grid = (n_tiles * n_split, Hkv, B)
    if grid[0] > MAX_GRID_X or Hkv > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"walk grid {grid} beyond the card's limits")
    slots = n_tiles * n_split * Hkv * B if n_split > 1 else 0
    return WalkPlan(n_tiles=n_tiles, nb_live=nb_live, pages_per_split=pps,
                    n_split=n_split, grid=grid,
                    workspace=slots * ROWS_PER_TILE * (D + 2),
                    counters=n_tiles * Hkv * B if n_split > 1 else 0)

launches = 0
int8_launches = 0
readonly_launches = 0
copy_launches = 0

_fns: Dict[str, object] = {}
_copy_errors: Dict[torch.device, torch.Tensor] = {}
_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _walk_fn():
    if "walk" not in _fns:
        lib = _build.library("paged_attention")
        fn = lib.paged_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        lib.paged_attention_rows_per_tile.restype = ctypes.c_int
        if lib.paged_attention_rows_per_tile() != ROWS_PER_TILE:
            raise RuntimeError("kernel.py and csrc/paged_attention.cu "
                               "disagree on the query rows per tile")
        _fns["walk"] = (fn, lib.paged_attention_error_string)
    return _fns["walk"]


def _counter_buffer(device: torch.device, stream: int, n: int):
    """The split walk's counters on ``device`` for launches on ``stream``:
    zero between launches (the kernel's last block resets its own), grown
    with zeros when a launch needs more."""
    key = (device, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 2 * (0 if buf is None else buf.numel())),
                          dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _copy_fn():
    if "copy" not in _fns:
        lib = _build.library("copy_page")
        fn = lib.copy_pages_launch
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        lib.copy_page_error_string.argtypes = [ctypes.c_int]
        lib.copy_page_error_string.restype = ctypes.c_char_p
        _fns["copy"] = (fn, lib.copy_page_error_string)
    return _fns["copy"]


def _check(q, k_new, v_new, k_pool, v_pool, block_tables, positions, *,
           k_scale=None, v_scale=None):
    """What the CUDA walk takes; raises for anything else (on any device).
    ``k_new``/``v_new`` are None for the read-only walk; with int8 pools
    they are the fresh rows in q's dtype, before quantization."""
    B, S, H, D = q.shape
    NB, BS, Hkv, Dp = k_pool.shape
    quant = k_scale is not None
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, "positions": positions}
    if k_new is not None:
        tensors.update(k_new=k_new, v_new=v_new)
    if quant:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    elif v_scale is not None:
        raise ValueError("k_scale and v_scale come together")
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in Q_DTYPES:
        raise TypeError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    pool_dtype = torch.int8 if quant else q.dtype
    for name in ("k_new", "v_new"):
        if name in tensors and tensors[name].dtype != q.dtype:
            raise TypeError(f"{name} is {tensors[name].dtype}, q {q.dtype}")
    for name in ("k_pool", "v_pool"):
        if tensors[name].dtype != pool_dtype:
            raise TypeError(f"{name} is {tensors[name].dtype}, the kernel "
                            f"takes {pool_dtype} pools here")
    if quant:
        for name in ("k_scale", "v_scale"):
            t = tensors[name]
            if t.dtype != torch.float32 or t.shape != (NB, BS, Hkv):
                raise TypeError(f"{name} must be float32 {(NB, BS, Hkv)}")
    for name in ("block_tables", "positions"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if Dp != D or v_pool.shape != k_pool.shape or H % Hkv:
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if k_new is not None and (k_new.shape != (B, S, Hkv, D)
                              or v_new.shape != k_new.shape):
        raise ValueError(f"k_new/v_new must be {(B, S, Hkv, D)}")
    if positions.shape != (B, S) or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise ValueError("positions must be (B, S), block_tables (B, MB)")
    if not 1 <= BS <= MAX_BLOCK_SIZE:
        raise ValueError(f"block_size {BS} not in [1, {MAX_BLOCK_SIZE}]")
    for name in ("q", "k_new", "v_new", "k_pool", "v_pool"):
        if name in tensors and tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(the kernel moves 16-byte vectors)")
    walk_plan(B, S, H // Hkv, Hkv, D, BS, block_tables.shape[1],
              block_tables.shape[1])          # the grid at the deepest walk


def _launch(q, fresh, k_pool, v_pool, scales, block_tables, positions, *,
            window, softcap, max_live_blocks):
    """One launch of the walk.  ``fresh``: (k_new, v_new) in q's dtype
    (the kernel quantizes them for int8 pools), or None for the read-only
    walk; ``scales``: (k_scale, v_scale) with int8 pools, else None.
    Returns out."""
    B, S, H, D = q.shape
    NB, BS, Hkv, _ = k_pool.shape
    MB = block_tables.shape[1]
    plan = walk_plan(B, S, H // Hkv, Hkv, D, BS, max_live_blocks, MB)
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    kn, vn = fresh if fresh is not None else (None, None)
    ks, vs = scales if scales is not None else (None, None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = counters = None
    if plan.n_split > 1:
        ws = torch.empty(plan.workspace, dtype=torch.float32,
                         device=q.device)
        counters = _counter_buffer(q.device, stream, plan.counters)
    fn, errstr = _walk_fn()
    err = fn(q.data_ptr(), ptr(kn), ptr(vn), k_pool.data_ptr(),
             v_pool.data_ptr(), ptr(ks), ptr(vs), block_tables.data_ptr(),
             positions.data_ptr(), out.data_ptr(), ptr(ws), ptr(counters),
             B, S, H, Hkv, D, BS, MB, plan.nb_live, plan.n_split,
             plan.pages_per_split, int(window), D ** -0.5, float(softcap),
             Q_DTYPES[q.dtype], int(scales is not None),
             int(fresh is not None), stream)
    if err:
        raise RuntimeError(f"paged attention launch failed: "
                           f"{errstr(err).decode()} ({err})")
    return out


def paged_attention_update(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           positions: torch.Tensor, *, window: int,
                           softcap: float, max_live_blocks: int,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None):
    """Scatter this step's fresh K/V rows, then attend over the pages.

    q (B, S, H, D) and k_new/v_new (B, S, Hkv, D) in one dtype (fp32 or
    bf16), D in ``HEAD_DIMS``; pools (NB, BS, Hkv, D) of that dtype, or
    int8 with ``k_scale``/``v_scale`` (NB, BS, Hkv) fp32 scale pools;
    block_tables (B, MB) and positions (B, S) int32, -1 marking padded
    rows.  The walk covers at most ``max_live_blocks`` logical blocks per
    request.  With int8 pools the kernel quantizes the fresh rows itself,
    bit-equal to ``ref.quantize_rows``, and scatters the int8 rows and
    their scales: one launch, no other.  Returns (out (B, S, H, D),
    k_pool, v_pool), plus (k_scale, v_scale) with int8 pools; the pools
    are updated in place.  Never synchronises with the host.
    """
    global launches, int8_launches
    if q.device.type == "cpu":
        return _ref.unified_attention_update(
            q, k_new, v_new, k_pool, v_pool, block_tables, positions,
            window=window, softcap=softcap, max_live_blocks=max_live_blocks,
            k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k_new, v_new, k_pool, v_pool, block_tables, positions,
           k_scale=k_scale, v_scale=v_scale)
    scales = None if k_scale is None else (k_scale, v_scale)
    out = _launch(q, (k_new, v_new), k_pool, v_pool, scales, block_tables,
                  positions, window=window, softcap=softcap,
                  max_live_blocks=max_live_blocks)
    if q.numel():
        if k_scale is None:
            launches += 1
        else:
            int8_launches += 1
    if k_scale is None:
        return out, k_pool, v_pool
    return out, k_pool, v_pool, k_scale, v_scale


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    positions: torch.Tensor, *, window: int, softcap: float,
                    max_live_blocks: int,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The read-only walk: attention over the pages as they are, no
    scatter.  Shapes and types as :func:`paged_attention_update` without
    k_new/v_new.  Returns out (B, S, H, D); the pools are not written."""
    global readonly_launches
    if q.device.type == "cpu":
        return _ref.paged_attention(q, k_pool, v_pool, block_tables,
                                    positions, window=window,
                                    softcap=softcap,
                                    max_live_blocks=max_live_blocks,
                                    k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, None, None, k_pool, v_pool, block_tables, positions,
           k_scale=k_scale, v_scale=v_scale)
    scales = None if k_scale is None else (k_scale, v_scale)
    out = _launch(q, None, k_pool, v_pool, scales, block_tables, positions,
                  window=window, softcap=softcap,
                  max_live_blocks=max_live_blocks)
    if q.numel():
        readonly_launches += 1
    return out


def copy_pages(pools: Sequence[torch.Tensor], src: Union[int, torch.Tensor],
               dst: Optional[int] = None) -> List[torch.Tensor]:
    """Copy page ``src`` over page ``dst`` in every layer of every pool, in
    place, in one launch; returns the pools as a list.

    ``pools``: 1 to ``MAX_POOLS`` contiguous stacked (L, NB, ...) pools on
    one device that share L and NB and may differ in dtype and page bytes
    (a cache's K and V pools, and with int8 pages their scale pools).  The
    ids are host ints (``copy_pages(pools, 3, 7)``), checked here and
    raising ValueError for ``src == dst`` or an id outside [0, NB), then
    passed to the kernel by value; or one int32 tensor ``{src, dst}`` on
    the pools' device (``copy_pages(pools, ids)``), read by the kernel with
    no host sync.  The kernel checks those itself: bad ids copy nothing in
    any pool and set the device's error flag, which
    :func:`copy_page_errors` reads.
    """
    global copy_launches
    pools = list(pools)
    if not 1 <= len(pools) <= MAX_POOLS:
        raise ValueError(f"copy_pages takes 1 to {MAX_POOLS} pools, got "
                         f"{len(pools)}")
    dev = pools[0].device
    L, NB = pools[0].shape[:2] if pools[0].dim() >= 2 else (0, 0)
    for pool in pools:
        if pool.dim() < 2 or pool.shape[0] != L or pool.shape[1] != NB:
            raise ValueError(f"pools must share (L, NB): "
                             f"{[tuple(p.shape) for p in pools]}")
        if pool.device != dev:
            raise ValueError(f"pools on {pool.device} and {dev}")
    if dst is None:
        ids = src
        if not (isinstance(ids, torch.Tensor) and ids.dtype == torch.int32
                and ids.shape == (2,)):
            raise TypeError("ids must be an int32 tensor {src, dst}")
    else:
        src, dst = int(src), int(dst)
        if src == dst or not (0 <= src < NB and 0 <= dst < NB):
            raise ValueError(f"copy_page: src {src}, dst {dst} must be two "
                             f"different pages of [0, {NB})")
        ids = None
    if dev.type == "cpu":
        if ids is not None:
            src, dst = (int(i) for i in ids)
            if src == dst or not (0 <= src < NB and 0 <= dst < NB):
                raise ValueError(f"copy_page: bad page ids {src}, {dst}")
        return _ref.copy_pages(pools, src, dst)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for pool in pools:
        if pool.dim() < 3 or not pool.is_contiguous():
            raise ValueError("pools must be contiguous (L, NB, ...) tensors")
    if ids is not None:
        if ids.device != dev:
            raise ValueError(f"ids are on {ids.device}, the pools on {dev}")
        ids = ids.contiguous()
    if pools[0].numel() == 0:
        return pools
    n = len(pools)
    bases = (ctypes.c_void_p * n)(*(p.data_ptr() for p in pools))
    page_bytes = (ctypes.c_longlong * n)(      # contiguous: numel / (L NB)
        *(p.numel() // (L * NB) * p.element_size() for p in pools))
    fn, errstr = _copy_fn()
    err = fn(bases, page_bytes, n, L, NB,
             -1 if ids is not None else src, -1 if ids is not None else dst,
             None if ids is None else ids.data_ptr(),
             _copy_error_flag(dev).data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"copy_pages launch failed: "
                           f"{errstr(err).decode()} ({err})")
    copy_launches += 1
    return pools


def copy_page(pool: torch.Tensor, src: Union[int, torch.Tensor],
              dst: Optional[int] = None) -> torch.Tensor:
    """Copy page ``src`` over page ``dst`` in every layer of a contiguous
    stacked (L, NB, ...) pool of any dtype, in place; returns the pool.
    The one-pool case of :func:`copy_pages`: the same ids, checks and
    kernel, one launch."""
    return copy_pages([pool], src, dst)[0]


def _copy_error_flag(device: torch.device) -> torch.Tensor:
    dev = torch.device(device.type, device.index if device.index is not None
                       else torch.cuda.current_device())
    if dev not in _copy_errors:
        _copy_errors[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _copy_errors[dev]


def copy_page_errors(device: torch.device) -> int:
    """How many launches of :func:`copy_pages` on ``device`` were given bad
    device-side ids since the last call (counted as 0 or 1: the flag is
    set, not added to), then clears the flag.  Synchronises with the
    device."""
    flag = _copy_error_flag(device)
    n = int(flag.item())
    flag.zero_()
    return n
