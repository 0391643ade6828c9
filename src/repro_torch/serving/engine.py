"""PagedServingEngine in PyTorch: continuous batching over a block-allocated
KV cache.  The counterpart of ``repro/serving/engine.py::PagedServingEngine``.

What is ported:

  * the unified tick (default): ONE ``unified_step`` pass over a flat
    ragged token batch (DESIGN.md §8): each active request contributes one
    token (decoding) or up to ``prefill_chunk`` tokens (prefilling),
    capped by ``token_budget`` through ``FCFSScheduler.plan_tick``.  The
    whole tick crosses host -> device as ONE packed int32 buffer and only
    the (R, W) greedy argmax ids come back, as in the JAX engine;
  * the two-dispatch tick (``unified=False``): one ``paged_step`` pass for
    the prefill chunks, then one for the decodes;
  * FCFS admission, and recompute preemption when the page pool runs dry
    mid-decode (admission never preempts);
  * int8 KV pools (``kv_dtype="int8"``, DESIGN.md §13);
  * the prefix cache (``prefix_cache=True``, DESIGN.md §9): content-hashed
    full pages, shared by incref at admission, copied on the device
    (``ops.copy_page``) before a request writes into a shared page;
  * telemetry (``repro_torch.obs``) and the ``metrics()`` report.

Options of later slices raise ``NotImplementedError`` naming their
ROADMAP.md item: ``speculate``, ``preempt="swap"``, ``host_cache_pages``
and ``mesh``.  (Their messages keep the item numbers the ROADMAP had when
the gates were written: "Queue 1 item 6" for the serving options, "Queue 1
item 13" for ``mesh``.)

Correctness contract (tested): a request served through this engine yields
exactly the tokens the port's isolated greedy ``launch.serve.generate``
produces, under ragged prompts, mid-flight admission, slot reuse and
preemption.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models.layers import compute_dtype
from repro_torch.obs import ServingTelemetry
from repro_torch.serving import paged_attn
from repro_torch.serving.blocks import BlockAllocator, BlockTable, page_digest
from repro_torch.serving.scheduler import FCFSScheduler

IDLE, PREFILL, DECODE = "idle", "prefill", "decode"


@dataclass
class PagedRequest:
    req_id: int
    prompt: np.ndarray                 # (S0,) int32
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    done: bool = False
    oom: bool = False                  # finished by pool/table exhaustion
    cancelled: bool = False            # aborted via cancel(), not completed

    def prefill_tokens(self) -> np.ndarray:
        """Tokens to (re)prefill.  Fresh: the prompt.  Preempted: prompt +
        all-but-last generated (the last generated token is fed by the
        next decode step, exactly as it would have been pre-preemption)."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated[:-1], np.int32)])


def _later(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported to PyTorch yet (ROADMAP.md {item})")


class PagedServingEngine:
    """Continuous-batching serving engine over a paged KV cache.

        >>> eng = PagedServingEngine(cfg, params, max_slots=4)
        >>> rid = eng.submit(prompt_tokens, max_new_tokens=32)
        >>> results = eng.run_to_completion()      # {req_id: [token, ...]}

    or stream via ``step()`` (returns ``{req_id: token}`` per tick).

    Args:
        cfg: a dense decoder-only ``ModelConfig``.
        params: the port's parameters (``models.model.init_params`` or
            ``weights.params_from_numpy``), on ``device``.
        max_slots: concurrent in-flight requests (request rows per tick).
        block_size: tokens per KV page.
        max_blocks_per_seq: block-table width; the per-request cap is
            ``max_blocks_per_seq * block_size`` tokens (prompt + generated).
        num_blocks: page-pool size *including* the reserved null page; the
            default fits every slot's full table plus the null page.
        prefill_chunk: max prompt tokens per prefilling slot per tick.
        token_budget: cap on tokens packed into one tick.  Decoding
            requests always fit; the rest goes to prefilling requests in
            FCFS order.  ``None`` packs every decode plus a full chunk per
            prefilling slot.
        unified: ``True`` (default) runs the one-pass unified tick;
            ``False`` the two-dispatch tick (a prefill pass, then a decode
            pass): the same token streams, one more dispatch per tick
            when prefills and decodes overlap.
        prefix_cache: automatic prefix caching (DESIGN.md §9).  Full pages
            are registered under token-chain digests as they fill;
            released pages park in a zero-ref LRU; admission attaches the
            longest cached prefix of a prompt by incref and prefills only
            the tail.  A write into a shared page first copies it on the
            device (``ops.copy_page`` over every pool of the cache).
            Streams are byte-identical with the cache on or off.
        telemetry: ``True`` (default) records one trace event per tick,
            request spans and latency histograms (``metrics()``,
            :meth:`dump_trace`); ``False`` records nothing.
        trace_capacity: tick-ring size of the trace.
        preemption_policy: ``"longest"`` or ``"newest"``: who gives pages
            back when the pool runs dry mid-decode.
        kv_dtype: ``None``/``"fp"`` keeps pages in the model dtype;
            ``"int8"`` stores them quantized (one fp32 scale per token row
            and kv head in parallel scale pools), ``head_dim + 4`` bytes
            per row and head instead of ``head_dim * itemsize``.  Streams
            may differ from fp pages (quantization is lossy).
        live_block_quantum: floor for the live-block bound before
            power-of-two bucketing.
        device: where the cache lives and the ticks run; ``cuda`` unless
            given.  ``params`` must already be there.
        clock: time source for telemetry and scheduler stats.
    """

    def __init__(self, cfg, params, *, max_slots: int = 4,
                 block_size: int = 16,
                 max_blocks_per_seq: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: int = 16,
                 token_budget: Optional[int] = None,
                 unified: bool = True,
                 prefix_cache: bool = False,
                 speculate: bool = False,
                 telemetry: bool = True,
                 trace_capacity: int = 4096,
                 preemption_policy: str = "longest",
                 kv_dtype: Optional[str] = None,
                 preempt: str = "recompute",
                 host_cache_pages: int = 0,
                 live_block_quantum: int = 4,
                 mesh=None,
                 device: DeviceLike = None,
                 clock=None):
        if not paged_attn.supports(cfg):
            raise ValueError("paged engine needs a pure-attention "
                             "decoder-only arch")
        if speculate:
            raise _later("speculate=True", "Queue 1 item 6")
        if kv_dtype not in (None, "fp", "int8"):
            raise ValueError(f"kv_dtype must be None, 'fp' or 'int8', "
                             f"got {kv_dtype!r}")
        if preempt == "swap":
            raise _later("preempt='swap'", "Queue 1 item 6")
        if preempt != "recompute":
            raise ValueError(f"preempt must be 'recompute' or 'swap', "
                             f"got {preempt!r}")
        if host_cache_pages:
            raise _later("host_cache_pages", "Queue 1 item 6")
        if mesh is not None:
            raise _later("mesh= (tensor-parallel serving)",
                         "Queue 1 item 13")
        if token_budget is not None and token_budget < 1:
            raise ValueError("token_budget must be >= 1 (or None for "
                             "unbounded packing)")
        if live_block_quantum < 1:
            raise ValueError("live_block_quantum must be >= 1")
        self.device = resolve_device(device)
        wdev = params["embed"]["table"].device
        if wdev.type != self.device.type:
            raise ValueError(f"params are on {wdev}, the engine runs on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.block_size = block_size
        self.max_blocks = max_blocks_per_seq or -(-256 // block_size)
        self.num_blocks = num_blocks or max_slots * self.max_blocks + 1
        self.prefill_chunk = prefill_chunk
        self.token_budget = token_budget
        self.unified = unified
        self.prefix_cache = prefix_cache
        self.kv_dtype = "int8" if kv_dtype == "int8" else "fp"
        self.live_block_quantum = live_block_quantum
        self.dispatches = 0            # step passes launched so far
        self.prefix_hit_tokens = 0     # prompt tokens served from the cache
        self.prefix_lookup_tokens = 0  # prompt tokens matched against it
        if clock is None:
            clock = time.perf_counter
        self.telemetry = ServingTelemetry(enabled=telemetry,
                                          capacity=trace_capacity,
                                          clock=clock)
        # per-tick scratch: [packed, padded, prefill, decode] token counts
        # plus the fenced device-time window
        self._tick_pack = [0, 0, 0, 0]
        self._tick_device_s = 0.0
        self._tick_device_t0: Optional[float] = None

        self.cache = paged_attn.init_paged_cache(cfg, self.num_blocks,
                                                 block_size, self.device,
                                                 kv_dtype=self.kv_dtype)
        # an int8 page costs one byte per element plus one fp32 scale per
        # token row per kv head; the fp baseline rides beside it so
        # utilization() can report the capacity multiplier
        fp_page_bytes = (2 * cfg.n_layers * block_size * cfg.n_kv_heads
                         * cfg.head_dim * compute_dtype(cfg).itemsize)
        if self.kv_dtype == "int8":
            page_bytes = (2 * cfg.n_layers * block_size * cfg.n_kv_heads
                          * (cfg.head_dim + 4))
        else:
            page_bytes = fp_page_bytes
        self.alloc = BlockAllocator(self.num_blocks, block_size,
                                    page_bytes_per_shard=page_bytes,
                                    kv_dtype=self.kv_dtype,
                                    fp_page_bytes_per_shard=fp_page_bytes)
        self.tables = [BlockTable(self.alloc, self.max_blocks)
                       for _ in range(max_slots)]
        self.scheduler = FCFSScheduler(preemption_policy=preemption_policy,
                                       clock=clock,
                                       telemetry=self.telemetry)
        self._pending = None
        self.slot_req: List[Optional[PagedRequest]] = [None] * max_slots
        self.slot_phase = [IDLE] * max_slots
        self.slot_seq: List[Optional[np.ndarray]] = [None] * max_slots
        self.slot_filled = np.zeros(max_slots, np.int64)  # tokens in cache
        # per-slot digests of the full pages written (or attached) so far:
        # the prefix cache's registration cursor
        self.slot_chain: List[List[bytes]] = [[] for _ in range(max_slots)]
        self.finished: Dict[int, PagedRequest] = {}
        self._next_id = 0
        self._null_row = np.zeros((self.max_blocks,), np.int32)

    @property
    def capacity_tokens(self) -> int:
        """Hard per-request cap: block-table width in tokens."""
        return self.max_blocks * self.block_size

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int) -> int:
        """Queue a request; returns its ``req_id``.

        ``prompt`` is a 1-D int32 token array (non-empty);
        ``max_new_tokens >= 1`` tokens are generated greedily.  Requests
        that cannot fit the block table or the page pool raise
        ``ValueError`` up front.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the first "
                             "token is emitted from the prefill logits)")
        # the last generated token is emitted without being written back
        written = prompt.size + max_new_tokens - 1
        if written > self.capacity_tokens:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) needs {written} cache slots, over "
                f"the per-request capacity {self.capacity_tokens} "
                f"(= max_blocks_per_seq * block_size); raise "
                f"max_blocks_per_seq")
        if -(-written // self.block_size) > self.num_blocks - 1:
            raise ValueError(
                f"request needs {-(-written // self.block_size)} pages "
                f"but the pool only has {self.num_blocks - 1}; raise "
                f"num_blocks")
        req = PagedRequest(self._next_id, prompt, max_new_tokens)
        self._next_id += 1
        self.scheduler.submit(req, prompt.size)
        return req.req_id

    def cancel(self, req_id: int) -> bool:
        """Abort a request wherever it lives: waiting requests leave the
        queue, slot-held ones release their pages and free the slot.  It
        lands in ``finished`` with ``cancelled=True`` and the tokens it
        had.  Returns False if the request was unknown or already
        finished.  A slot-held request cannot be cancelled while a tick
        is in flight: call :meth:`step_end` first."""
        for req in self.scheduler.waiting:
            if req.req_id == req_id:
                self.scheduler.waiting.remove(req)
                req.done = req.cancelled = True
                self.finished[req_id] = req
                self.scheduler.on_cancel(req_id)
                return True
        for slot, req in enumerate(self.slot_req):
            if req is None or req.req_id != req_id:
                continue
            if self._pending is not None:
                raise RuntimeError(
                    f"cancel({req_id}): request holds slot {slot} and a "
                    f"tick is in flight; call step_end() before "
                    f"cancelling slot-held requests")
            req.done = req.cancelled = True
            self.finished[req_id] = req
            self.scheduler.on_cancel(req_id)
            self._clear_slot(slot)
            return True
        return False

    @property
    def active(self) -> int:
        """Requests currently holding a slot (prefilling or decoding)."""
        return sum(r is not None for r in self.slot_req)

    @property
    def queue(self) -> List[PagedRequest]:
        """Snapshot of the waiting (not yet admitted) requests, FCFS."""
        return list(self.scheduler.waiting)

    def metrics(self) -> Dict[str, object]:
        """Point-in-time engine report with the JAX engine's fields;
        sections of options not ported yet report their disabled shape."""
        hit, seen = self.prefix_hit_tokens, self.prefix_lookup_tokens
        return {"scheduler": self.scheduler.summary(),
                "blocks": self.alloc.utilization(),
                "queue_depth": len(self.scheduler.waiting),
                "free_page_fraction":
                    self.alloc.num_free / max(1, self.num_blocks - 1),
                "tick": "unified" if self.unified else "legacy",
                "token_budget": self.token_budget,
                "kv_dtype": self.kv_dtype,
                "preempt": "recompute",
                "swapped_requests_waiting": 0,
                "prefix_cache": {
                    "enabled": self.prefix_cache,
                    "hit_tokens": hit,
                    "lookup_tokens": seen,
                    "hit_rate": hit / seen if seen else 0.0,
                    "page_hits": self.alloc.cache_hits,
                    "evictions": self.alloc.cache_evictions,
                    "cow_copies": self.alloc.cow_copies,
                    "cached_pages": self.alloc.num_cached},
                "speculative": {
                    "enabled": False, "draft_k": 0, "drafted_tokens": 0,
                    "accepted_tokens": 0, "accept_rate": 0.0},
                "dispatches": self.dispatches,
                "attention_backend": ("cuda" if self.device.type == "cuda"
                                      else "reference"),
                "cluster": None,
                "oom_finished": sum(r.oom for r in self.finished.values()),
                "telemetry": self.telemetry.summary()}

    # ------------------------------------------------------------------
    # slot lifecycle
    # ------------------------------------------------------------------
    def _clear_slot(self, slot: int) -> None:
        self.tables[slot].release()
        self.slot_req[slot] = None
        self.slot_phase[slot] = IDLE
        self.slot_seq[slot] = None
        self.slot_filled[slot] = 0
        self.slot_chain[slot] = []

    def _finish(self, slot: int, *, oom: bool = False) -> None:
        req = self.slot_req[slot]
        req.done = True
        req.oom = oom
        self.finished[req.req_id] = req
        self.scheduler.on_finish(req.req_id)
        self._clear_slot(slot)

    def _vacate(self, slot: int) -> None:
        """Give the slot's pages back and requeue its request (front)."""
        self.scheduler.requeue_front(self.slot_req[slot])
        self._clear_slot(slot)

    def _vacate_dry(self, slot: int) -> None:
        """Admission-dry giveback: a prefilling slot could not get pages
        (admission never preempts), so it returns what it holds and waits.
        Recorded as a ``vacate`` span, not a preemption."""
        if self.telemetry.enabled:
            self.telemetry.span(self.slot_req[slot].req_id, "vacate",
                                self.telemetry.clock())
        self._vacate(slot)

    def _preempt(self, slot: int) -> None:
        self.scheduler.on_preempt(self.slot_req[slot].req_id)
        self._vacate(slot)

    def _choose_victim_for(self, slot: int) -> Optional[int]:
        """Pick a preemption victim to relieve pool pressure on ``slot``
        (zero-block slots free nothing — preempting them is pure churn)."""
        candidates = [(s, r.req_id, len(self.tables[s].blocks))
                      for s, r in enumerate(self.slot_req)
                      if r is not None and s != slot
                      and self.tables[s].blocks]
        return self.scheduler.choose_victim(candidates)

    def _ensure_blocks(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s table to cover ``n_tokens``, evicting victims
        per the scheduler's policy while the pool is dry (decode growth
        only: admission must not preempt, or two requests that each fit
        the pool alone but not together evict each other forever)."""
        while not self.tables[slot].ensure(n_tokens):
            victim = self._choose_victim_for(slot)
            if victim is None:
                return False
            self._preempt(victim)
        return True

    def _admit(self) -> None:
        for slot in range(self.max_slots):
            if self.slot_req[slot] is not None:
                continue
            req = self.scheduler.next_request()
            if req is None:
                return
            self.slot_req[slot] = req
            self.slot_phase[slot] = PREFILL
            seq = req.prefill_tokens()
            self.slot_seq[slot] = seq
            self.slot_filled[slot] = 0
            self.slot_chain[slot] = []
            if self.prefix_cache:
                matched, chain, blocks = self._match_prefix(seq)
                if blocks:
                    # attach the cached prefix by incref: prefill (and the
                    # scheduler's token budget) covers only the tail
                    self.tables[slot].fork_from_prefix(blocks)
                    self.slot_filled[slot] = matched
                    self.slot_chain[slot] = chain
                    self.prefix_hit_tokens += matched
                self.prefix_lookup_tokens += int(seq.size)
            self.scheduler.on_admit(req.req_id)

    def _accept(self, slot: int, tok: int, emitted: Dict[int, int]) -> None:
        """Record one decode row's greedy token."""
        req = self.slot_req[slot]
        self.slot_filled[slot] += 1
        req.generated.append(tok)
        self.scheduler.on_token(req.req_id)
        emitted[req.req_id] = tok
        self._register_pages(slot)
        if len(req.generated) >= req.max_new_tokens:
            self._finish(slot)

    # ------------------------------------------------------------------
    # prefix cache (DESIGN.md §9)
    # ------------------------------------------------------------------
    def _match_prefix(self, seq: np.ndarray):
        """Walk ``seq``'s token-chain digests through the allocator's hash
        index: the longest run of full pages already resident (in use by
        another request or parked in the zero-ref cache) is the cached
        prefix.  Returns ``(matched_tokens, chain, blocks)``.  At least one
        token is always left to prefill (the first generated token comes
        from the prompt's last logits), so a fully cached prompt recomputes
        its last token into a copy-on-write page."""
        bs = self.block_size
        chain: List[bytes] = []
        blocks: List[int] = []
        parent = b""
        for k in range(int(seq.size) // bs):
            digest = page_digest(parent, seq[k * bs:(k + 1) * bs])
            blk = self.alloc.lookup(digest)
            if blk is None:
                break
            chain.append(digest)
            blocks.append(blk)
            parent = digest
        matched = len(blocks) * bs
        if matched >= seq.size:
            matched = int(seq.size) - 1
            if len(blocks) >= self.num_blocks - 1:
                # a full match that alone fills the pool: the last token's
                # copy-on-write page could never be allocated, so match
                # page-aligned and re-prefill the last page instead
                chain.pop()
                blocks.pop()
                matched = len(blocks) * bs
        return matched, chain, blocks

    def _tokens_range(self, slot: int, a: int, b: int) -> np.ndarray:
        """Tokens written at positions [a, b) of ``slot``: prefill tokens
        from ``slot_seq``, decode-written ones from ``generated``."""
        seq = self.slot_seq[slot]
        if b <= seq.size:
            return seq[a:b]
        req = self.slot_req[slot]
        gen = np.asarray(req.generated, np.int32)
        # position p >= seq.size holds generated[p - prompt_size]
        tail = gen[seq.size - req.prompt.size:]
        return np.concatenate([seq, tail])[a:b]

    def _register_pages(self, slot: int) -> None:
        """Extend the slot's digest chain over pages that just became full
        and index them in the allocator (content-addressed, deduplicated)
        so later prompts can attach them."""
        if not self.prefix_cache:
            return
        bs = self.block_size
        chain = self.slot_chain[slot]
        for k in range(len(chain), int(self.slot_filled[slot]) // bs):
            parent = chain[-1] if chain else b""
            digest = page_digest(parent,
                                 self._tokens_range(slot, k * bs,
                                                    (k + 1) * bs))
            chain.append(digest)
            self.alloc.register(self.tables[slot].blocks[k], digest)

    def _cow_writable(self, slot: int, a: int, b: int, *,
                      may_preempt: bool) -> bool:
        """Make positions [a, b) of ``slot`` safe to scatter into: a shared
        page in that range is first copied on the device to a private page,
        so the kernel's fused scatter never writes a page another table or
        the hash index can still read.  The private page follows the
        caller's pressure policy: prefill never preempts (the caller
        vacates), decode growth may evict victims as ``_ensure_blocks``
        does.  Returns False when no page can be found."""
        tab = self.tables[slot]
        bs = self.block_size
        shared = tab.shared                # cow() shrinks it as we go
        for idx in range(a // bs, (b - 1) // bs + 1):
            if idx >= shared:
                break                      # shared pages are a prefix
            if not self.alloc.page_shared(tab.blocks[idx]):
                continue                   # already exclusively ours
            while True:
                new = self.alloc.allocate()
                if new is not None:
                    break
                if not may_preempt:
                    return False
                victim = self._choose_victim_for(slot)
                if victim is None:
                    return False
                self._preempt(victim)
            self._copy_page(tab.blocks[idx], new)
            tab.cow(idx, new)
        return True

    @torch.no_grad()
    def _copy_page(self, src: int, dst: int) -> None:
        """The COW step: page ``src`` over ``dst`` in every pool of the
        cache (K, V and, with int8 pages, their scale pools)."""
        for pool in self.cache.values():
            paged_ops.copy_page(pool, src, dst)

    def _grow_decode(self, slot: int) -> None:
        """Room for one decode token: grow the table (may preempt) and
        make the slot's next position writable; finish the request (OOM)
        when neither the table nor the pool has room."""
        filled = int(self.slot_filled[slot])
        if filled >= self.capacity_tokens:
            self._finish(slot, oom=True)     # out of table bounds
        elif not self._ensure_blocks(slot, filled + 1) \
                or not self._cow_writable(slot, filled, filled + 1,
                                          may_preempt=True):
            self._finish(slot, oom=True)     # pool dry, no victims

    # ------------------------------------------------------------------
    # the unified tick
    # ------------------------------------------------------------------
    def _unpack(self, buf: torch.Tensor, chm: int, vw: int):
        """Split the packed tick buffer (layout in ``_unified_launch``)
        into its typed views — slices, no copies."""
        R, MB = self.max_slots, self.max_blocks
        Tb = (buf.shape[0] - R * vw - R * chm - R * MB) // 2
        tokens = buf[:Tb]
        positions = buf[Tb:2 * Tb]
        off = 2 * Tb
        verify_idx = buf[off:off + R * vw].reshape(R, vw)
        row_map = buf[off + R * vw:off + R * vw + R * chm].reshape(R, chm)
        req_tables = buf[off + R * vw + R * chm:].reshape(R, MB)
        return tokens, positions, verify_idx, row_map, req_tables

    def _live_bound(self, positions: np.ndarray) -> int:
        """Live-block bound for one tick: the deepest position any row
        touches decides how many logical blocks attention walks, rounded
        up (quantum floor, then next power of two) like the JAX engine's
        static bound."""
        live = int(positions.max()) // self.block_size + 1
        live = max(live, self.live_block_quantum)
        return min(1 << (live - 1).bit_length(), self.max_blocks)

    @torch.no_grad()
    def _greedy_unified(self, buf: torch.Tensor, live: int, chm: int,
                        vw: int) -> torch.Tensor:
        """The device work of one tick; returns the (R, vw) greedy ids
        (still on the device — the caller's copy is the tick's sync)."""
        t, pos, vidx, rmap, tabs = self._unpack(buf, chm, vw)
        logits, _ = paged_attn.unified_step(
            self.cfg, self.params, self.cache, t, pos, tabs, rmap, vidx,
            max_live_blocks=live, max_seg_len=chm)
        return torch.argmax(logits[..., :self.cfg.vocab], dim=-1).to(
            torch.int32)

    def _unified_launch(self) -> Optional[Dict[str, object]]:
        """Plan + pack + LAUNCH the unified tick without waiting for its
        result.  Returns the in-flight context for :meth:`_unified_collect`,
        or None when there was nothing to pack.

        Planning: prefill page growth first (vacate, never preempt, when
        the pool is dry), then decode growth, which may preempt per
        policy."""
        prefill_req = []
        for slot, req in enumerate(self.slot_req):
            if req is None or self.slot_phase[slot] != PREFILL:
                continue
            need = self.slot_seq[slot].size - int(self.slot_filled[slot])
            prefill_req.append((slot, req.req_id, need))
        decode_slots = [s for s, r in enumerate(self.slot_req)
                        if r is not None and self.slot_phase[s] == DECODE]
        grants = self.scheduler.plan_tick(self.token_budget, decode_slots,
                                          prefill_req, self.prefill_chunk)
        plan = []  # (slot, start, end)
        for slot, _rid, _need in prefill_req:
            n = grants.get(slot, 0)
            if n <= 0:
                continue
            start = int(self.slot_filled[slot])
            if not self.tables[slot].ensure(start + n) \
                    or not self._cow_writable(slot, start, start + n,
                                              may_preempt=False):
                # pool dry: admission never preempts — give back whatever
                # was allocated and wait for in-flight requests to free
                # pages; submit() guarantees the request fits eventually
                self._vacate_dry(slot)
                continue
            plan.append((slot, start, start + n))
        for slot in decode_slots:
            if self.slot_req[slot] is None:
                continue                         # preempted by an earlier slot
            self._grow_decode(slot)
        plan = [(s, a, b) for s, a, b in plan
                if self.slot_req[s] is not None
                and self.slot_phase[s] == PREFILL]
        decoding = [s for s in decode_slots
                    if self.slot_req[s] is not None
                    and self.slot_phase[s] == DECODE]
        if not plan and not decoding:
            return None
        # -- pack the flat ragged batch ----------------------------------
        # Tb always leaves at least one padded tail row for the dead
        # row_map / verify entries (position -1, null table); buckets are
        # multiples of 4 capped at the pack's true maximum
        T = len(decoding) + sum(end - start for _, start, end in plan)
        Tb = min(-(-(T + 1) // 4) * 4,
                 self.max_slots * self.prefill_chunk + 1)
        R, MB = self.max_slots, self.max_blocks
        chunk_max = max([end - start for _, start, end in plan] + [1])
        chm = min(1 << (chunk_max - 1).bit_length(), Tb)
        vw = 1
        # ONE packed int32 buffer carries the whole tick —
        #   [tokens | positions | verify_idx | row_map | req_tables]
        # — one host->device copy per tick.  Block tables ride per
        # REQUEST row, never once per packed token.
        buf = np.zeros(2 * Tb + R * vw + R * chm + R * MB, np.int32)
        tokens = buf[:Tb]
        positions = buf[Tb:2 * Tb]
        positions[:] = -1
        verify_idx = buf[2 * Tb:2 * Tb + R * vw].reshape(R, vw)
        verify_idx[:] = T      # dead entries hit the padded tail row
        row_map = buf[2 * Tb + R * vw:2 * Tb + R * vw + R * chm] \
            .reshape(R, chm)
        row_map[:] = T
        req_tables = buf[2 * Tb + R * vw + R * chm:].reshape(R, MB)
        r = 0
        for slot in decoding:
            tokens[r] = self.slot_req[slot].generated[-1]
            positions[r] = int(self.slot_filled[slot])
            req_tables[slot] = self.tables[slot].as_row()
            verify_idx[slot, 0] = r
            row_map[slot, 0] = r
            r += 1
        for slot, start, end in plan:
            n = end - start
            tokens[r:r + n] = self.slot_seq[slot][start:end]
            positions[r:r + n] = np.arange(start, end, dtype=np.int32)
            req_tables[slot] = self.tables[slot].as_row()
            verify_idx[slot, 0] = r + n - 1
            row_map[slot, :n] = np.arange(r, r + n, dtype=np.int32)
            r += n
        self._tick_pack = [T, Tb, T - len(decoding), len(decoding)]
        fence = self.telemetry.enabled
        f0 = 0.0
        if fence:
            f0 = self.telemetry.clock()
            if self._tick_device_t0 is None:
                self._tick_device_t0 = f0
        next_tokens = self._greedy_unified(
            torch.from_numpy(buf).to(self.device),
            self._live_bound(positions), chm, vw)
        self.dispatches += 1
        return {"next_tokens": next_tokens, "decoding": decoding,
                "plan": plan, "fence": fence, "f0": f0}

    def _unified_collect(self, ctx: Optional[Dict[str, object]]
                         ) -> Dict[int, int]:
        """Copy the tick's ids to the host (the tick's only device sync)
        and unpack: accept decode tokens, advance prefill cursors, emit
        first tokens, finish slots."""
        emitted: Dict[int, int] = {}
        if ctx is None:
            return emitted
        next_tokens = ctx["next_tokens"].cpu().numpy()   # (max_slots, 1)
        if ctx["fence"]:
            self._tick_device_s += self.telemetry.clock() - ctx["f0"]
        for slot in ctx["decoding"]:
            self._accept(slot, int(next_tokens[slot, 0]), emitted)
        for slot, start, end in ctx["plan"]:
            self._advance_prefill(slot, end, int(next_tokens[slot, 0]),
                                  emitted)
        return emitted

    def _advance_prefill(self, slot: int, end: int, nxt: int,
                         emitted: Dict[int, int]) -> bool:
        """A prefill chunk of ``slot`` up to position ``end`` has run;
        ``nxt`` is the greedy id at its last token.  Registers the pages it
        filled; on the prompt's last chunk moves the slot to decode and
        emits the first generated token.  Returns True when the slot
        became decodable."""
        req = self.slot_req[slot]
        self.slot_filled[slot] = end
        self._register_pages(slot)
        if end < self.slot_seq[slot].size:
            return False                 # more chunks to go
        self.slot_phase[slot] = DECODE
        if not req.generated:
            # first generated token comes from the prompt's last logits
            req.generated.append(nxt)
            emitted[req.req_id] = nxt
            self.scheduler.on_token(req.req_id)
        if len(req.generated) >= req.max_new_tokens:
            self._finish(slot)
        return True

    # ------------------------------------------------------------------
    # the two-dispatch tick (unified=False)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _run(self, tokens: np.ndarray, positions: np.ndarray,
             tables: np.ndarray) -> np.ndarray:
        """One ``paged_step`` pass of the two-dispatch tick; returns the
        (B, S) greedy next-token ids on the host (the pass's sync)."""
        fence = self.telemetry.enabled
        t0 = 0.0
        if fence:
            t0 = self.telemetry.clock()
            if self._tick_device_t0 is None:
                self._tick_device_t0 = t0
        dev = self.device
        logits, _ = paged_attn.paged_step(
            self.cfg, self.params, self.cache,
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(positions).to(dev),
            torch.from_numpy(tables).to(dev),
            max_live_blocks=self._live_bound(positions))
        self.dispatches += 1
        out = torch.argmax(logits[..., :self.cfg.vocab], dim=-1).to(
            torch.int32).cpu().numpy()
        if fence:
            self._tick_device_s += self.telemetry.clock() - t0
        return out

    def _prefill_tick(self):
        """One chunk of prefill for every admitting slot, in one pass.
        Returns ({req_id: first_token} for prompts completed this tick,
        the set of slots that just became decodable: they sit out this
        tick's decode, so a step emits at most one token per request)."""
        emitted: Dict[int, int] = {}
        ready: set = set()
        C = self.prefill_chunk
        plan = []  # (slot, start, end)
        for slot, req in enumerate(self.slot_req):
            if req is None or self.slot_phase[slot] != PREFILL:
                continue
            start = int(self.slot_filled[slot])
            end = min(start + C, self.slot_seq[slot].size)
            if not self.tables[slot].ensure(end) \
                    or not self._cow_writable(slot, start, end,
                                              may_preempt=False):
                self._vacate_dry(slot)     # admission never preempts
                continue
            plan.append((slot, start, end))
        if not plan:
            return emitted, ready
        n_pf = sum(end - start for _, start, end in plan)
        tp = self._tick_pack   # every slot is padded to a whole chunk
        tp[0] += n_pf
        tp[1] += self.max_slots * C
        tp[2] += n_pf
        tokens = np.zeros((self.max_slots, C), np.int32)
        positions = np.full((self.max_slots, C), -1, np.int32)
        tables = np.tile(self._null_row, (self.max_slots, 1))
        for slot, start, end in plan:
            n = end - start
            tokens[slot, :n] = self.slot_seq[slot][start:end]
            positions[slot, :n] = np.arange(start, end, dtype=np.int32)
            tables[slot] = self.tables[slot].as_row()
        next_tokens = self._run(tokens, positions, tables)
        for slot, start, end in plan:
            if self._advance_prefill(slot, end,
                                     int(next_tokens[slot, end - start - 1]),
                                     emitted):
                ready.add(slot)
        return emitted, ready

    def _decode_tick(self, skip=frozenset()) -> Dict[int, int]:
        """One decode pass: one token for every decoding slot (``skip``:
        slots whose prefill completed this very tick)."""
        emitted: Dict[int, int] = {}
        for slot, req in enumerate(self.slot_req):
            if req is None or self.slot_phase[slot] != DECODE \
                    or slot in skip:
                continue
            self._grow_decode(slot)
        decoding = [s for s, r in enumerate(self.slot_req)
                    if r is not None and self.slot_phase[s] == DECODE
                    and s not in skip]
        if not decoding:
            return emitted
        tp = self._tick_pack
        tp[0] += len(decoding)
        tp[1] += self.max_slots
        tp[3] += len(decoding)
        tokens = np.zeros((self.max_slots, 1), np.int32)
        positions = np.full((self.max_slots, 1), -1, np.int32)
        tables = np.tile(self._null_row, (self.max_slots, 1))
        for slot in decoding:
            tokens[slot, 0] = self.slot_req[slot].generated[-1]
            positions[slot, 0] = int(self.slot_filled[slot])
            tables[slot] = self.tables[slot].as_row()
        next_tokens = self._run(tokens, positions, tables)
        for slot in decoding:
            self._accept(slot, int(next_tokens[slot, 0]), emitted)
        return emitted

    # ------------------------------------------------------------------
    def step_begin(self) -> Dict[str, object]:
        """Admit + plan + pack + LAUNCH one tick without waiting for its
        result.  Pair with :meth:`step_end`.  Between the two the host may
        ``submit()`` (and cancel waiting requests)."""
        if self._pending is not None:
            raise RuntimeError("step_begin() called with a tick already "
                               "in flight; call step_end() first")
        tel = self.telemetry
        pend: Dict[str, object] = {"kind": "unified" if self.unified
                                   else "legacy"}
        if tel.enabled:
            self._tick_pack = [0, 0, 0, 0]
            self._tick_device_s = 0.0
            self._tick_device_t0 = None
            pend["pre"] = (self.scheduler.preemptions_total,
                           self.alloc.cow_copies, self.prefix_hit_tokens,
                           self.dispatches, len(self.finished))
            pend["t0"] = tel.clock()
        self._admit()
        if self.unified:
            pend["ctx"] = self._unified_launch()
        else:
            # the two-dispatch tick syncs between its passes, so it runs
            # whole here and step_end returns what it emitted
            emitted, fresh = self._prefill_tick()
            emitted.update(self._decode_tick(skip=fresh))
            pend["emitted"] = emitted
        self._pending = pend
        return pend

    def step_end(self, pending: Optional[Dict[str, object]] = None
                 ) -> Dict[int, int]:
        """Sync + unpack the tick launched by :meth:`step_begin` and record
        its telemetry event.  Returns the tick's {req_id: token}."""
        if pending is None:
            pending = self._pending
        if pending is None or pending is not self._pending:
            raise RuntimeError("step_end() without a matching "
                               "step_begin()")
        self._pending = None
        if "emitted" in pending:
            emitted = pending["emitted"]
        else:
            emitted = self._unified_collect(pending["ctx"])
        tel = self.telemetry
        if "t0" in pending:
            pre = pending["pre"]
            in_use, cached, free = self.alloc.snapshot()
            pk = self._tick_pack
            tel.record_tick(
                t=pending["t0"], kind=pending["kind"],
                wall_s=tel.clock() - pending["t0"],
                device_s=self._tick_device_s,
                device_t=self._tick_device_t0,
                packed_tokens=pk[0], padded_tokens=pk[1],
                prefill_tokens=pk[2], decode_tokens=pk[3],
                emitted=len(emitted),
                live_slots=self.active,
                waiting=len(self.scheduler.waiting),
                pool_free=free, pool_cached=cached, pool_in_use=in_use,
                prefix_hit_tokens=self.prefix_hit_tokens - pre[2],
                preemptions=self.scheduler.preemptions_total - pre[0],
                cow_copies=self.alloc.cow_copies - pre[1],
                dispatches=self.dispatches - pre[3],
                finished=len(self.finished) - pre[4],
                quant=self.kv_dtype == "int8")
        return emitted

    def step(self) -> Dict[int, int]:
        """Admit, then advance every in-flight request by one tick: one
        token per decoding slot and one chunk per prefilling slot, in ONE
        pass (two on the ``unified=False`` tick).  Returns {req_id: new_token}, including first tokens from
        completed prefills.  Exactly ``step_end(step_begin())``."""
        return self.step_end(self.step_begin())

    def dump_trace(self, path, fmt: Optional[str] = None) -> str:
        """Write the telemetry trace (JSONL, or Chrome trace_event when
        ``path`` ends in ``.json``) with ``metrics()`` as the meta record.
        Returns the format written."""
        if not self.telemetry.enabled:
            raise RuntimeError("engine was built with telemetry=False; "
                               "nothing was recorded to dump")
        return self.telemetry.dump(path, fmt=fmt, meta=self.metrics())

    def clear_finished(self) -> Dict[int, List[int]]:
        """Drop retained finished requests and their accounting; returns
        what was dropped."""
        out = {rid: r.generated for rid, r in self.finished.items()}
        for rid in self.finished:
            self.scheduler.forget(rid)
        self.finished.clear()
        return out

    def _state_fingerprint(self):
        """Hashable snapshot of every input the next tick's decisions
        read; an emit-less step that leaves it unchanged can never make
        progress later."""
        return (tuple(r.req_id for r in self.scheduler.waiting),
                tuple((r.req_id, self.slot_phase[s],
                       int(self.slot_filled[s]), len(r.generated))
                      for s, r in enumerate(self.slot_req)
                      if r is not None),
                len(self.finished), self.alloc.snapshot())

    def _raise_stuck(self, reason: str) -> None:
        stuck = sorted([r.req_id for r in self.slot_req if r is not None]
                       + [r.req_id for r in self.scheduler.waiting])
        raise RuntimeError(
            f"run_to_completion: {reason} with {self.active} active and "
            f"{len(self.scheduler.waiting)} waiting requests "
            f"(req ids {stuck}); a silent partial result is "
            f"indistinguishable from a complete one")

    def run_to_completion(self, max_steps: int = 10_000
                          ) -> Dict[int, List[int]]:
        """Drain queue + slots; returns every request finished so far.
        Raises RuntimeError if work remains after ``max_steps``, or as
        soon as two consecutive emit-less steps leave the engine state
        unchanged (a livelock)."""
        last_fp = None
        for _ in range(max_steps):
            if not self.scheduler.has_waiting and self.active == 0:
                break
            if self.step():
                last_fp = None
                continue
            fp = self._state_fingerprint()
            if fp == last_fp:
                self._raise_stuck("no step can make progress (every "
                                  "admissible slot is blocked)")
            last_fp = fp
        if self.scheduler.has_waiting or self.active:
            self._raise_stuck(f"step budget exhausted after {max_steps} "
                              f"steps; raise max_steps")
        return {rid: req.generated for rid, req in self.finished.items()}
