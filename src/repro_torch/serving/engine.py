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
  * FCFS admission, and preemption when the page pool runs dry mid-decode
    (admission never preempts): the victim's pages are recomputed
    (``preempt="recompute"``) or parked in host RAM and restored on
    resume (``preempt="swap"``, DESIGN.md §13);
  * int8 KV pools (``kv_dtype="int8"``, DESIGN.md §13);
  * the prefix cache (``prefix_cache=True``, DESIGN.md §9): content-hashed
    full pages, shared by incref at admission, copied on the device
    (``ops.copy_pages``) before a request writes into a shared page; with
    ``host_cache_pages`` evicted pages spill to a host tier and a later
    prefix match restores them;
  * self-speculative decoding (``speculate=True``, DESIGN.md §11): n-gram
    drafts ride the tick as verify chains of up to ``draft_k + 1`` rows a
    request, accepted by exact greedy match;
  * telemetry (``repro_torch.obs``) and the ``metrics()`` report.

``mesh`` (tensor-parallel serving) raises ``NotImplementedError`` naming
its ROADMAP.md item.  (The message keeps the item number the ROADMAP had
when the gate was written, "Queue 1 item 13".)

Correctness contract (tested): a request served through this engine yields
exactly the tokens the port's isolated greedy ``launch.serve.generate``
produces, under ragged prompts, mid-flight admission, slot reuse and
preemption.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Collection, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models.layers import compute_dtype
from repro_torch.obs import ServingTelemetry
from repro_torch.serving import paged_attn
from repro_torch.serving.blocks import BlockAllocator, BlockTable, page_digest
from repro_torch.serving.scheduler import FCFSScheduler
from repro_torch.serving.speculative import NGramDrafter

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

    or stream via ``step()`` (returns ``{req_id: token}`` per tick, or
    ``{req_id: [token, ...]}`` with ``speculate=True``).

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
            device (``ops.copy_pages``: every pool of the cache in one
            launch).  Streams are byte-identical with the cache on or off.
        speculate: self-speculative decoding (DESIGN.md §11).  Each
            decoding request keeps an n-gram index over its prompt and
            accepted tokens (:class:`~repro_torch.serving.speculative
            .NGramDrafter`) and proposes up to ``draft_k`` tokens a tick;
            the chain rides the tick scored at every position, and the
            longest prefix the greedy argmax reproduces is accepted plus
            one bonus token.  Streams are byte-identical to greedy
            decoding; rejected rows only rewind ``slot_filled`` (their K/V
            is overwritten before any accepted row can attend to it).
        draft_k: most draft tokens a request proposes a tick (>= 1).
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
        preempt: what preemption does with a victim's pages (DESIGN.md
            §13).  ``"recompute"`` frees them and re-prefills on
            re-admission; ``"swap"`` first copies the written pages of
            every pool to host RAM (``BlockAllocator.swap_out``) and
            re-admission copies them back into fresh pages: the same
            streams, no re-prefill.
        host_cache_pages: capacity in pages of the digest-keyed host
            prefix cache: a zero-ref cached page evicted under pool
            pressure first copies its bytes there, and a later prefix
            match restores them into a fresh page instead of
            re-prefilling.  0 disables it.
        swap_pages_per_tick: soft cap on pages swapped in a tick
            (``preempt="swap"``); a tick's first resume always proceeds.
            ``None``: no cap.
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
                 draft_k: int = 4,
                 telemetry: bool = True,
                 trace_capacity: int = 4096,
                 preemption_policy: str = "longest",
                 kv_dtype: Optional[str] = None,
                 preempt: str = "recompute",
                 host_cache_pages: int = 0,
                 swap_pages_per_tick: Optional[int] = None,
                 live_block_quantum: int = 4,
                 mesh=None,
                 device: DeviceLike = None,
                 clock=None):
        if not paged_attn.supports(cfg):
            raise ValueError("paged engine needs a pure-attention "
                             "decoder-only arch")
        if kv_dtype not in (None, "fp", "int8"):
            raise ValueError(f"kv_dtype must be None, 'fp' or 'int8', "
                             f"got {kv_dtype!r}")
        if preempt not in ("recompute", "swap"):
            raise ValueError(f"preempt must be 'recompute' or 'swap', "
                             f"got {preempt!r}")
        if swap_pages_per_tick is not None and swap_pages_per_tick < 1:
            raise ValueError("swap_pages_per_tick must be >= 1 or None")
        if draft_k < 1:
            raise ValueError("draft_k must be >= 1")
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
        self.preempt = preempt
        self.swap_pages_per_tick = swap_pages_per_tick
        # req_id -> (handle, phase, filled, chain) of swapped-out requests
        # waiting to copy their pages back
        self._swap_handles: Dict[int, tuple] = {}
        self._tick_swap = [0, 0]       # [pages in, pages out] this tick
        self.speculate = speculate
        self.draft_k = draft_k
        self.spec_drafted_total = 0    # draft tokens packed into passes
        self.spec_accepted_total = 0   # of those, accepted by the verify
        self._tick_spec = [0, 0]       # [drafted, accepted] this tick
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
                                    fp_page_bytes_per_shard=fp_page_bytes,
                                    host_cache_pages=host_cache_pages)
        if host_cache_pages > 0:
            self.alloc.spill_hook = self._spill_page
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
        # per-slot n-gram drafters (speculate=True): built at the
        # prefill-to-decode transition, extended with accepted tokens only,
        # dropped with the slot's pages
        self.slot_drafter: List[Optional[NGramDrafter]] = [None] * max_slots
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
                ent = self._swap_handles.pop(req_id, None)
                if ent is not None:
                    self.alloc.swap_discard(ent[0])
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
        """Point-in-time engine report with the JAX engine's fields."""
        hit, seen = self.prefix_hit_tokens, self.prefix_lookup_tokens
        drafted, accepted = self.spec_drafted_total, self.spec_accepted_total
        return {"scheduler": self.scheduler.summary(),
                "blocks": self.alloc.utilization(),
                "queue_depth": len(self.scheduler.waiting),
                "free_page_fraction":
                    self.alloc.num_free / max(1, self.num_blocks - 1),
                "tick": "unified" if self.unified else "legacy",
                "token_budget": self.token_budget,
                "kv_dtype": self.kv_dtype,
                "preempt": self.preempt,
                "swapped_requests_waiting": len(self._swap_handles),
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
                    "enabled": self.speculate, "draft_k": self.draft_k,
                    "drafted_tokens": drafted, "accepted_tokens": accepted,
                    "accept_rate": accepted / drafted if drafted else 0.0},
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
        self.slot_drafter[slot] = None

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
        if self.preempt == "swap":
            self._swap_out_slot(slot)
        self._vacate(slot)

    # ------------------------------------------------------------------
    # host swap tier (DESIGN.md §13)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _pages_to_host(self, blocks: List[int]) -> Dict[str, torch.Tensor]:
        """Copy the given pages of every pool (every layer) to the host,
        one gather and one blocking copy a pool.  Payloads stay torch
        tensors: numpy has no bf16."""
        idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
        return {name: pool[:, idx].cpu() for name, pool in self.cache.items()}

    @torch.no_grad()
    def _pages_from_host(self, blocks: List[int],
                         payload: Dict[str, torch.Tensor]) -> None:
        """Copy a host payload back into the given (freshly allocated)
        pages of every pool, in place; exactly those pages are written."""
        idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
        for name, pool in self.cache.items():
            pool[:, idx] = payload[name].to(self.device)

    def _written_pages(self, slot: int) -> int:
        """Pages of ``slot`` holding written K/V rows (the partial tail
        page counts; allocated-but-unwritten pages past it do not)."""
        return -(-int(self.slot_filled[slot]) // self.block_size)

    def _swap_out_slot(self, slot: int) -> None:
        """Park the slot's written pages on the host before ``_vacate``
        decrefs them; re-admission restores the bytes instead of
        recomputing (``preempt="swap"``)."""
        n = self._written_pages(slot)
        if n == 0:
            return
        req = self.slot_req[slot]
        payload = self._pages_to_host(self.tables[slot].blocks[:n])
        handle = self.alloc.swap_out(n, payload)
        self._swap_handles[req.req_id] = (
            handle, self.slot_phase[slot], int(self.slot_filled[slot]),
            list(self.slot_chain[slot]))
        self._tick_swap[1] += n
        if self.telemetry.enabled:
            self.telemetry.span(req.req_id, "swap_out",
                                self.telemetry.clock(), pages=n)

    def _swap_resume(self, slot: int, req: PagedRequest) -> bool:
        """Restore a swapped-out request into ``slot``: allocate its pages
        (admission never preempts), copy the host payload back and resume
        where it was vacated.  Returns False, leaving the handle parked,
        when the pool cannot provide the pages yet or the tick's swap
        budget is spent."""
        handle, phase, filled, chain = self._swap_handles[req.req_id]
        n = self.alloc.swap_pages(handle)
        cap = self.swap_pages_per_tick
        if cap is not None and self._tick_swap[0] > 0 \
                and self._tick_swap[0] + n > cap:
            return False     # budget spent; a tick's first resume proceeds
        blocks: List[int] = []
        for _ in range(n):
            blk = self.alloc.allocate()
            if blk is None:
                if blocks:
                    self.alloc.free(blocks)
                return False
            blocks.append(blk)
        n_pages, payload = self.alloc.swap_in(handle)
        del self._swap_handles[req.req_id]
        self._pages_from_host(blocks, payload)
        tab = self.tables[slot]
        tab.blocks = blocks
        tab.shared = 0           # restored pages are private copies
        self.slot_req[slot] = req
        self.slot_phase[slot] = phase
        self.slot_seq[slot] = req.prefill_tokens()
        self.slot_filled[slot] = filled
        self.slot_chain[slot] = chain if self.prefix_cache else []
        if phase == DECODE and self.speculate:
            self._make_drafter(slot)
        self._tick_swap[0] += n_pages
        if self.telemetry.enabled:
            self.telemetry.span(req.req_id, "swap_in",
                                self.telemetry.clock(), pages=n_pages)
        return True

    def _spill_page(self, blk: int, digest: bytes) -> None:
        """Allocator spill hook: a zero-ref cached page is about to be
        evicted for reuse; keep its bytes in the digest-keyed host cache
        so that a later prefix match can restore them."""
        self.alloc.host_put(digest, self._pages_to_host([blk]))
        self._tick_swap[1] += 1

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
            if req.req_id in self._swap_handles:
                # a swapped-out request copies its pages back instead of
                # recomputing; when it cannot yet (pool dry, swap budget
                # spent) it keeps the head of the line and admission stops
                if self._swap_resume(slot, req):
                    self.scheduler.on_admit(req.req_id)
                    continue
                self.scheduler.requeue_front(req)
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

    # ------------------------------------------------------------------
    # speculative decoding (DESIGN.md §11)
    # ------------------------------------------------------------------
    def _make_drafter(self, slot: int) -> None:
        """(Re)build the slot's n-gram index over the prompt and every
        accepted token: at the prefill-to-decode transition, and on a swap
        resume (the drafter is dropped with the slot)."""
        req = self.slot_req[slot]
        dr = NGramDrafter()
        dr.reset(np.concatenate(
            [req.prompt, np.asarray(req.generated, np.int32)]))
        self.slot_drafter[slot] = dr

    def _propose(self, slot: int) -> List[int]:
        """The slot's draft for this tick: up to ``draft_k`` tokens from its
        n-gram index, capped so that the bonus token still has output room
        (``max_new_tokens``) and the chain fits the block table."""
        dr = self.slot_drafter[slot]
        if dr is None:
            return []
        req = self.slot_req[slot]
        k = min(self.draft_k,
                req.max_new_tokens - len(req.generated) - 1,
                self.capacity_tokens - int(self.slot_filled[slot]) - 1)
        if k <= 0:
            return []
        return dr.draft(k)

    def _accept(self, slot: int, draft: List[int], ids: np.ndarray,
                emitted: Dict[int, object]) -> None:
        """Exact accept and rollback for one decode chain.  ``ids[j]`` is
        the greedy id after chain position ``j`` (the chain: the last
        generated token, then the draft).  The longest draft prefix the
        model reproduces is accepted, plus the bonus token ``ids[m]``:
        what one-token greedy decoding gives, token for token.
        ``slot_filled`` advances over accepted positions only; the
        rejected rows' K/V is overwritten before any later row attends to
        it.  With ``draft == []`` this is a plain decode row."""
        req = self.slot_req[slot]
        m = 0
        while m < len(draft) and int(ids[m]) == draft[m]:
            m += 1
        toks = list(draft[:m]) + [int(ids[m])]
        self.slot_filled[slot] += m + 1
        for t in toks:
            req.generated.append(t)
            self.scheduler.on_token(req.req_id)
        if self.speculate:
            if self.slot_drafter[slot] is not None:
                self.slot_drafter[slot].extend(toks)
            self._tick_spec[1] += m
            self.spec_accepted_total += m
            if draft and self.telemetry.enabled:
                self.telemetry.spec_accept_len.record(m)
            emitted[req.req_id] = toks
        else:
            emitted[req.req_id] = toks[0]
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
            if blk is None and self.alloc.host_cache_pages > 0:
                blk = self._restore_host_page(digest, avoid=blocks)
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

    def _restore_host_page(self, digest: bytes,
                           avoid: Collection[int] = ()) -> Optional[int]:
        """A prefix hit in the host tier: copy the spilled page back into a
        fresh device page, re-register its digest and park it zero-ref in
        the device cache, so ``fork_from_prefix`` attaches it like any
        other cached page.  None when the host tier misses too or the
        pool is dry.

        ``avoid``: the pages the prefix walk matched so far.  They are not
        attached yet, so a zero-ref one is still evictable; the fresh page
        must not be taken from them, or the table would hold one page
        twice.  (The JAX engine's ``_restore_host_page`` takes the LRU
        page whatever it is, and then serves wrong tokens.)"""
        payload = self.alloc.host_lookup(digest)
        if payload is None:
            return None
        blk = self.alloc.allocate(avoid=avoid)
        if blk is None:
            self.alloc.host_put(digest, payload)     # keep the bytes
            return None
        self._pages_from_host([blk], payload)
        self.alloc.register(blk, digest)
        self.alloc.decref([blk])     # zero-ref cached, attachable
        self._tick_swap[0] += 1
        return blk

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
        cache (K, V and, with int8 pages, their scale pools), in one
        launch.  One COW a launch, in stream order: the page a later COW
        of the same step writes may be this one's ``src``, freed by
        ``tab.cow`` and allocated again."""
        paged_ops.copy_pages(list(self.cache.values()), src, dst)

    def _grow_decode(self, slot: int, draft: int = 0) -> int:
        """Room for a decode chain of ``1 + draft`` tokens: grow the table
        (may preempt) and make positions ``[filled, filled + 1 + draft)``
        writable.  When the chain does not fit, fall back to one token;
        finish the request (OOM) when neither the table nor the pool has
        room for that.  Returns the draft length that fits."""
        filled = int(self.slot_filled[slot])
        if draft and self._ensure_blocks(slot, filled + 1 + draft) \
                and self._cow_writable(slot, filled, filled + 1 + draft,
                                       may_preempt=True):
            return draft
        if filled >= self.capacity_tokens:
            self._finish(slot, oom=True)     # out of table bounds
        elif not self._ensure_blocks(slot, filled + 1) \
                or not self._cow_writable(slot, filled, filled + 1,
                                          may_preempt=True):
            self._finish(slot, oom=True)     # pool dry, no victims
        return 0

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
        policy.  With ``speculate=True`` each decoding slot may pack its
        draft chain: the scheduler grants draft tokens from what the
        budget leaves after the prefill chunks, and the chain rides as a
        segment scored at every position through ``verify_idx``."""
        prefill_req = []
        for slot, req in enumerate(self.slot_req):
            if req is None or self.slot_phase[slot] != PREFILL:
                continue
            need = self.slot_seq[slot].size - int(self.slot_filled[slot])
            prefill_req.append((slot, req.req_id, need))
        decode_slots = [s for s, r in enumerate(self.slot_req)
                        if r is not None and self.slot_phase[s] == DECODE]
        drafts: Dict[int, List[int]] = {}
        if self.speculate and decode_slots:
            want = []
            for slot in decode_slots:
                prop = self._propose(slot)
                if prop:
                    drafts[slot] = prop
                    want.append((slot, self.slot_req[slot].req_id,
                                 len(prop)))
            grants, draft_grants = self.scheduler.plan_tick(
                self.token_budget, decode_slots, prefill_req,
                self.prefill_chunk, draft=want)
            drafts = {s: d[:draft_grants.get(s, 0)]
                      for s, d in drafts.items() if draft_grants.get(s, 0)}
        else:
            grants = self.scheduler.plan_tick(
                self.token_budget, decode_slots, prefill_req,
                self.prefill_chunk)
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
            if not self._grow_decode(slot, len(drafts.get(slot, ()))):
                drafts.pop(slot, None)           # the chain did not fit
        plan = [(s, a, b) for s, a, b in plan
                if self.slot_req[s] is not None
                and self.slot_phase[s] == PREFILL]
        decoding = [s for s in decode_slots
                    if self.slot_req[s] is not None
                    and self.slot_phase[s] == DECODE]
        drafts = {s: d for s, d in drafts.items() if s in set(decoding)}
        if not plan and not decoding:
            return None
        # -- pack the flat ragged batch ----------------------------------
        # Tb always leaves at least one padded tail row for the dead
        # row_map / verify entries (position -1, null table); buckets are
        # multiples of 4 capped at the pack's true maximum
        drafted = sum(len(d) for d in drafts.values())
        seg = [1 + len(drafts.get(s, ())) for s in decoding]
        T = sum(seg) + sum(end - start for _, start, end in plan)
        row_cap = max(self.prefill_chunk,
                      1 + self.draft_k if self.speculate else 1)
        Tb = min(-(-(T + 1) // 4) * 4, self.max_slots * row_cap + 1)
        R, MB = self.max_slots, self.max_blocks
        chunk_max = max([end - start for _, start, end in plan] + seg + [1])
        chm = min(1 << (chunk_max - 1).bit_length(), Tb)
        # verify width: the positions a request needs logits at — its last
        # packed token, or its whole draft chain; bucketed like chm
        vw = 1
        if drafts:
            vw = min(1 << (max(seg) - 1).bit_length(), self.draft_k + 1)
        # ONE packed int32 buffer carries the whole tick —
        #   [tokens | positions | verify_idx | row_map | req_tables]
        # — one host->device copy per tick.  Block tables ride per
        # REQUEST row, never once per packed token.  On the card the
        # buffer is pinned and the copy asynchronous, so the launch waits
        # for nothing already queued (another replica's tick on the same
        # card) and step_begin returns with the tick in flight
        host = torch.zeros(2 * Tb + R * vw + R * chm + R * MB,
                           dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")
        buf = host.numpy()
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
            # the decode segment is the chain: the last generated token,
            # then the draft, at consecutive positions
            chain = ([self.slot_req[slot].generated[-1]]
                     + drafts.get(slot, []))
            n = len(chain)
            filled = int(self.slot_filled[slot])
            tokens[r:r + n] = chain
            positions[r:r + n] = np.arange(filled, filled + n,
                                           dtype=np.int32)
            req_tables[slot] = self.tables[slot].as_row()
            verify_idx[slot, :n] = np.arange(r, r + n, dtype=np.int32)
            row_map[slot, :n] = np.arange(r, r + n, dtype=np.int32)
            r += n
        for slot, start, end in plan:
            n = end - start
            tokens[r:r + n] = self.slot_seq[slot][start:end]
            positions[r:r + n] = np.arange(start, end, dtype=np.int32)
            req_tables[slot] = self.tables[slot].as_row()
            verify_idx[slot, 0] = r + n - 1
            row_map[slot, :n] = np.arange(r, r + n, dtype=np.int32)
            r += n
        self._tick_pack = [T, Tb, T - sum(seg), sum(seg)]
        self._tick_spec[0] += drafted
        self.spec_drafted_total += drafted
        fence = self.telemetry.enabled
        f0 = 0.0
        if fence:
            f0 = self.telemetry.clock()
            if self._tick_device_t0 is None:
                self._tick_device_t0 = f0
        next_tokens = self._greedy_unified(
            host.to(self.device, non_blocking=True),
            self._live_bound(positions), chm, vw)
        self.dispatches += 1
        return {"next_tokens": next_tokens, "decoding": decoding,
                "drafts": drafts, "plan": plan, "fence": fence, "f0": f0}

    def _unified_collect(self, ctx: Optional[Dict[str, object]]
                         ) -> Dict[int, object]:
        """Copy the tick's ids to the host (the tick's only device sync)
        and unpack: accept decode chains, advance prefill cursors, emit
        first tokens, finish slots."""
        emitted: Dict[int, object] = {}
        if ctx is None:
            return emitted
        next_tokens = ctx["next_tokens"].cpu().numpy()   # (max_slots, vw)
        if ctx["fence"]:
            self._tick_device_s += self.telemetry.clock() - ctx["f0"]
        for slot in ctx["decoding"]:
            self._accept(slot, ctx["drafts"].get(slot, []),
                         next_tokens[slot], emitted)
        for slot, start, end in ctx["plan"]:
            self._advance_prefill(slot, end, int(next_tokens[slot, 0]),
                                  emitted)
        return emitted

    def _advance_prefill(self, slot: int, end: int, nxt: int,
                         emitted: Dict[int, object]) -> bool:
        """A prefill chunk of ``slot`` up to position ``end`` has run;
        ``nxt`` is the greedy id at its last token.  Registers the pages it
        filled; on the prompt's last chunk moves the slot to decode, emits
        the first generated token and builds the slot's drafter.  Returns
        True when the slot became decodable."""
        req = self.slot_req[slot]
        self.slot_filled[slot] = end
        self._register_pages(slot)
        if end < self.slot_seq[slot].size:
            return False                 # more chunks to go
        self.slot_phase[slot] = DECODE
        if not req.generated:
            # first generated token comes from the prompt's last logits
            req.generated.append(nxt)
            emitted[req.req_id] = [nxt] if self.speculate else nxt
            self.scheduler.on_token(req.req_id)
        if len(req.generated) >= req.max_new_tokens:
            self._finish(slot)
        elif self.speculate:
            self._make_drafter(slot)
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
        emitted: Dict[int, object] = {}
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

    def _decode_tick(self, skip=frozenset()) -> Dict[int, object]:
        """One decode pass: one token for every decoding slot (``skip``:
        slots whose prefill completed this very tick).  With
        ``speculate=True`` each slot also packs its draft chain (this tick
        has no token budget, so drafts are never cut) and the pass is
        ``W`` rows a slot, the longest chain bucketed."""
        emitted: Dict[int, object] = {}
        drafts: Dict[int, List[int]] = {}
        for slot, req in enumerate(self.slot_req):
            if req is None or self.slot_phase[slot] != DECODE \
                    or slot in skip:
                continue
            prop = self._propose(slot) if self.speculate else []
            if self._grow_decode(slot, len(prop)):
                drafts[slot] = prop
        decoding = [s for s, r in enumerate(self.slot_req)
                    if r is not None and self.slot_phase[s] == DECODE
                    and s not in skip]
        if not decoding:
            return emitted
        drafts = {s: d for s, d in drafts.items() if s in set(decoding)}
        drafted = sum(len(d) for d in drafts.values())
        W = 1
        if self.speculate:
            wmax = max(1 + len(drafts.get(s, ())) for s in decoding)
            W = min(1 << (wmax - 1).bit_length(), self.draft_k + 1)
        tp = self._tick_pack   # every slot is padded to the chain width
        tp[0] += len(decoding) + drafted
        tp[1] += self.max_slots * W
        tp[3] += len(decoding) + drafted
        self._tick_spec[0] += drafted
        self.spec_drafted_total += drafted
        tokens = np.zeros((self.max_slots, W), np.int32)
        positions = np.full((self.max_slots, W), -1, np.int32)
        tables = np.tile(self._null_row, (self.max_slots, 1))
        for slot in decoding:
            chain = ([self.slot_req[slot].generated[-1]]
                     + drafts.get(slot, []))
            n = len(chain)
            filled = int(self.slot_filled[slot])
            tokens[slot, :n] = chain
            positions[slot, :n] = np.arange(filled, filled + n,
                                            dtype=np.int32)
            tables[slot] = self.tables[slot].as_row()
        next_tokens = self._run(tokens, positions, tables)
        for slot in decoding:
            self._accept(slot, drafts.get(slot, []), next_tokens[slot],
                         emitted)
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
        self._tick_spec = [0, 0]
        self._tick_swap = [0, 0]
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
                 ) -> Dict[int, object]:
        """Sync + unpack the tick launched by :meth:`step_begin` and record
        its telemetry event.  Returns the tick's emitted tokens (see
        :meth:`step`)."""
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
            n_emitted = (sum(len(v) for v in emitted.values())
                         if self.speculate else len(emitted))
            tel.record_tick(
                t=pending["t0"], kind=pending["kind"],
                wall_s=tel.clock() - pending["t0"],
                device_s=self._tick_device_s,
                device_t=self._tick_device_t0,
                packed_tokens=pk[0], padded_tokens=pk[1],
                prefill_tokens=pk[2], decode_tokens=pk[3],
                drafted=self._tick_spec[0], accepted=self._tick_spec[1],
                emitted=n_emitted, live_slots=self.active,
                waiting=len(self.scheduler.waiting),
                pool_free=free, pool_cached=cached, pool_in_use=in_use,
                prefix_hit_tokens=self.prefix_hit_tokens - pre[2],
                preemptions=self.scheduler.preemptions_total - pre[0],
                cow_copies=self.alloc.cow_copies - pre[1],
                dispatches=self.dispatches - pre[3],
                finished=len(self.finished) - pre[4],
                swap_in=self._tick_swap[0], swap_out=self._tick_swap[1],
                quant=self.kv_dtype == "int8")
        return emitted

    def step(self) -> Dict[int, object]:
        """Admit, then advance every in-flight request by one tick: one
        token per decoding slot and one chunk per prefilling slot, in ONE
        pass (two on the ``unified=False`` tick).  Returns {req_id:
        new_token}, including first tokens from completed prefills; with
        ``speculate=True`` a request may advance by several tokens (its
        accepted draft and the bonus), and the values are token lists.
        Exactly ``step_end(step_begin())``."""
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
