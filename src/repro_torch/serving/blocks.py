"""KV-page bookkeeping: a ref-counted block allocator with a prefix cache,
and per-request block tables with copy-on-write fork support.  A copy of
``repro/serving/blocks.py`` with one difference: :meth:`BlockAllocator
.allocate` takes ``avoid=``, the pages that eviction must not take (the
engine's prefix walk passes the pages it matched before a host-tier
restore; see ``engine.PagedServingEngine._restore_host_page``).

The KV cache is one pooled array of ``num_blocks`` fixed-size pages per
layer (see ``paged_attn.init_paged_cache``); requests own pages through a
:class:`BlockTable` that maps logical block index -> physical page id.

Ownership is *ref-counted*, not exclusive: several requests may hold the
same physical page (automatic prefix caching — a shared system prompt is
prefilled and stored once).  Every page is in exactly one of three states:

  * **in-use** — ref count >= 1: owned by one or more live block tables.
  * **cached** — ref count == 0 but the page is *full* and registered
    under its token-chain content hash (:func:`page_digest`): it sits in
    an LRU and can be resurrected by a later hash hit
    (:meth:`BlockAllocator.attach`) or reclaimed by :meth:`allocate`
    under pool pressure (free pages are always handed out first).
  * **free** — on the free list, contents garbage.

``free()`` is therefore a *decref* (and is kept as an alias of
:meth:`BlockAllocator.decref`): a finished or preempted request releasing
its table moves hashed pages to the cache instead of the free list, so the
next request with the same prompt prefix attaches them by incref and skips
re-prefilling.  A request about to *write* into a shared page must
copy-on-write first (:meth:`BlockTable.cow` after the engine's on-device
``ops.copy_pages``); pages are append-only, so only the tail page of a
forked prefix can ever need it.

Physical page 0 is reserved as the *null block*: padded prefill rows and
inactive decode slots route their writes there, so it is never handed out
and its contents are garbage by design (always masked at read time).

The allocator also fronts the *host swap tier* (DESIGN.md §13): preempted
requests can park their page payloads in host RAM
(:meth:`BlockAllocator.swap_out` / :meth:`swap_in`) instead of recomputing
them, and zero-ref cached pages evicted under pool pressure can spill
their bytes to a digest-keyed host prefix cache (``spill_hook`` +
:meth:`host_put` / :meth:`host_lookup`).  The allocator never touches
device memory itself — payloads are opaque host objects the engine
gathers/scatters; the allocator only owns the bookkeeping and counters.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Callable, Collection, Dict, Iterable, List, Optional

import numpy as np

NULL_BLOCK = 0


def page_digest(parent: bytes, tokens: np.ndarray) -> bytes:
    """Token-chain content hash of one full page.

    ``parent`` is the previous page's digest (``b""`` for page 0), so a
    digest commits to the *entire token prefix* up to and including this
    page — required for KV reuse, because a page's K/V rows depend on
    every earlier token through the layer stack, not just on the page's
    own tokens.  Collision-resistant (sha256) because a false hit would
    silently serve another prompt's KV.
    """
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    return hashlib.sha256(parent + toks.tobytes()).digest()


class BlockAllocator:
    """Ref-counted allocator over a pool of fixed-size KV pages.

    Page ids are *global*: on a cluster-sharded engine every shard holds
    its kv-head slice of the same ``num_blocks`` pages, so one allocator
    (on the host) governs the whole cluster and ``num_blocks`` is the
    per-shard pool size in pages.  Ref counts, the content-hash index and
    the zero-ref LRU cache are host-side bookkeeping only — sharding
    never sees them.  ``num_shards`` / ``page_bytes_per_shard`` only feed
    the accounting in :meth:`utilization`: N-way sharding divides each
    device's page bytes by N — the headroom an operator spends by raising
    ``num_blocks`` (see docs/serving.md).

    Args:
        num_blocks: pool size in pages, including reserved page 0 (the
            null block, never handed out).
        block_size: tokens per page.
        num_shards: devices the KV pool is sharded over (1 = single device).
        page_bytes_per_shard: bytes one page occupies on one shard
            (``2 * n_layers * block_size * kv_heads_per_shard * head_dim *
            itemsize`` — int8 pools add the fp32 scale rows); None omits
            the byte fields from accounting.
        kv_dtype: ``"fp"`` or ``"int8"`` — accounting label only (the
            engine owns the actual pool dtype); surfaced through
            :meth:`utilization` next to the byte fields.
        fp_page_bytes_per_shard: what one page *would* cost unquantized —
            lets :meth:`utilization` report the capacity multiplier an
            int8 pool buys at fixed pool bytes.
        host_cache_pages: capacity (in pages) of the digest-keyed host
            prefix cache that evicted zero-ref pages spill into (0 =
            spill disabled; swap_out/swap_in are always available).
    """

    def __init__(self, num_blocks: int, block_size: int, *,
                 num_shards: int = 1,
                 page_bytes_per_shard: Optional[int] = None,
                 kv_dtype: str = "fp",
                 fp_page_bytes_per_shard: Optional[int] = None,
                 host_cache_pages: int = 0):
        assert num_blocks >= 2, "need at least the null block + one page"
        assert block_size >= 1
        assert num_shards >= 1
        assert kv_dtype in ("fp", "int8"), kv_dtype
        assert host_cache_pages >= 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.num_shards = num_shards
        self.page_bytes_per_shard = page_bytes_per_shard
        self.kv_dtype = kv_dtype
        self.fp_page_bytes_per_shard = fp_page_bytes_per_shard
        # FIFO recycling: freed pages go to the back, so reuse is spread
        # across the pool (easier to spot stale-read bugs in tests).
        self._free = deque(range(1, num_blocks))
        self._refs = [0] * num_blocks
        self._page_hash: List[Optional[bytes]] = [None] * num_blocks
        self._hash_index: Dict[bytes, int] = {}
        # zero-ref cached pages, insertion order = LRU order (attach moves
        # a page out; decref-to-zero re-appends at the MRU end)
        self._cached: "OrderedDict[int, bytes]" = OrderedDict()
        self._in_use = 0
        self.peak_in_use = 0
        self.total_allocated = 0
        self.total_freed = 0
        self.cache_hits = 0        # pages attached through a hash hit
        self.cache_evictions = 0   # cached pages reclaimed by allocate()
        self.cow_copies = 0        # private copies made before shared writes
        # ---- host swap tier (DESIGN.md §13) --------------------------
        # preempted-request payloads, handle -> (n_pages, payload); the
        # payload is opaque to the allocator (the engine stores gathered
        # host arrays of the pages' bytes)
        self._swap_store: Dict[int, tuple] = {}
        self._swap_next = 1
        # digest-keyed host prefix cache: evicted zero-ref pages spill
        # their bytes here (insertion order = LRU order, like _cached)
        self._host_cache: "OrderedDict[bytes, object]" = OrderedDict()
        self.host_cache_pages = host_cache_pages
        # called as spill_hook(blk, digest) just before allocate() evicts
        # a cached page — the engine's chance to gather the page to host
        # (host_put); never set by the allocator itself
        self.spill_hook: Optional[Callable[[int, bytes], None]] = None
        self.swapped_out_pages = 0   # pages parked on host via swap_out
        self.swapped_in_pages = 0    # pages streamed back via swap_in
        self.host_cache_hits = 0     # host_lookup hits (digest resident)
        self.host_cache_spills = 0   # pages spilled into the host cache

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_cached(self) -> int:
        return len(self._cached)

    @property
    def num_in_use(self) -> int:
        return self._in_use

    def snapshot(self) -> tuple:
        """Cheap per-tick pool read for telemetry: ``(in_use, cached,
        free)`` page counts — three ints, no dict churn on the hot path
        (the full accounting view is :meth:`utilization`)."""
        return self._in_use, len(self._cached), len(self._free)

    def _validate(self, blk) -> int:
        """Out-of-range / null page ids are hard errors, never silent."""
        blk = int(blk)
        if blk == NULL_BLOCK:
            raise ValueError("null block is never allocated or released")
        if not 0 < blk < self.num_blocks:
            raise ValueError(f"page id {blk} outside pool "
                             f"[1, {self.num_blocks})")
        return blk

    def allocate(self, avoid: Collection[int] = ()) -> Optional[int]:
        """One private page (ref count 1), or None when the pool is
        exhausted.  Free pages are handed out first; under pressure the
        least-recently-used *cached* page not in ``avoid`` is evicted (its
        hash entry is dropped, so later lookups of that prefix simply
        miss)."""
        if self._free:
            blk = self._free.popleft()
        else:
            blk = next((b for b in self._cached if b not in avoid), None)
            if blk is None:
                return None
            digest = self._cached.pop(blk)              # LRU end first
            if self.spill_hook is not None and self.host_cache_pages > 0 \
                    and digest not in self._host_cache:
                # last chance to keep the page's bytes: the engine's hook
                # gathers them to host (host_put) before reuse clobbers
                # the device page
                self.spill_hook(blk, digest)
            del self._hash_index[digest]
            self._page_hash[blk] = None
            self.cache_evictions += 1
        self._refs[blk] = 1
        self._in_use += 1
        self.total_allocated += 1
        self.peak_in_use = max(self.peak_in_use, self._in_use)
        return blk

    def attach(self, blk: int) -> None:
        """Take a reference on a page found through :meth:`lookup` —
        incref if in-use, resurrect from the cache if zero-ref.  Either
        way the page keeps its hash registration (it stays shareable).
        A resurrection counts as an allocation, so ``total_allocated -
        total_freed == num_in_use`` holds with the cache on or off."""
        blk = self._validate(blk)
        if self._refs[blk] == 0:
            if blk not in self._cached:
                raise ValueError(f"page {blk} is free; attach() is only "
                                 f"for in-use or cached pages")
            del self._cached[blk]
            self._refs[blk] = 1
            self._in_use += 1
            self.total_allocated += 1
            self.peak_in_use = max(self.peak_in_use, self._in_use)
        else:
            self._refs[blk] += 1
        self.cache_hits += 1

    def decref(self, blocks: Iterable[int]) -> None:
        """Drop one reference per page.  A page reaching zero refs moves
        to the cached LRU when it is registered in the hash index
        (resurrectable by a later prefix match), to the free list
        otherwise.  Double-frees and out-of-range ids raise ValueError
        instead of silently corrupting the pool accounting."""
        for blk in blocks:
            blk = self._validate(blk)
            if self._refs[blk] <= 0:
                raise ValueError(f"double free of page {blk} "
                                 f"(ref count already 0)")
            self._refs[blk] -= 1
            if self._refs[blk]:
                continue
            self._in_use -= 1
            self.total_freed += 1
            digest = self._page_hash[blk]
            if digest is not None and self._hash_index.get(digest) == blk:
                self._cached[blk] = digest           # MRU end
            else:
                self._page_hash[blk] = None
                self._free.append(blk)

    # the historical name: releasing pages is a decref now (ref-counted
    # ownership), kept so existing callers/tests read naturally
    free = decref

    def register(self, blk: int, digest: bytes) -> bool:
        """Index an in-use *full* page under its token-chain digest.

        Returns True when ``blk`` now backs ``digest``.  If another page
        already holds the digest (two requests prefilled the same prompt
        concurrently), the first registration wins and this page stays
        unindexed — it will return to the free list on release instead of
        duplicating the cache entry.
        """
        blk = self._validate(blk)
        if self._refs[blk] <= 0:
            raise ValueError(f"register of page {blk} with no references")
        if digest in self._hash_index:
            return self._hash_index[digest] == blk
        old = self._page_hash[blk]
        if old is not None and self._hash_index.get(old) == blk:
            # re-registration: a page backs at most one index entry, so a
            # later free/evict can never leave a dangling digest -> page
            del self._hash_index[old]
        self._hash_index[digest] = blk
        self._page_hash[blk] = digest
        return True

    def lookup(self, digest: bytes) -> Optional[int]:
        """Physical page currently backing ``digest`` (in-use or cached),
        or None.  Take a reference with :meth:`attach` before using it."""
        return self._hash_index.get(digest)

    # ------------------------------------------------------------------
    # host swap tier (DESIGN.md §13)
    # ------------------------------------------------------------------
    @property
    def host_pages(self) -> int:
        """Pages currently resident on the host: swapped-out request
        payloads plus the digest-keyed host prefix cache."""
        return (sum(n for n, _ in self._swap_store.values())
                + len(self._host_cache))

    def swap_out(self, n_pages: int, payload) -> int:
        """Park a preempted request's page payload on the host; returns
        the handle :meth:`swap_in` redeems.  ``payload`` is opaque (the
        engine stores gathered host arrays); ``n_pages`` only feeds the
        accounting."""
        assert n_pages >= 1
        handle = self._swap_next
        self._swap_next += 1
        self._swap_store[handle] = (int(n_pages), payload)
        self.swapped_out_pages += n_pages
        return handle

    def swap_pages(self, handle: int) -> int:
        """Pages a parked payload will need on restore (peek, no pop)."""
        return self._swap_store[handle][0]

    def swap_peek(self, handle: int):
        """Read a parked payload without consuming it.  The replica
        router migrates evacuated requests' page bytes into another
        replica's host prefix cache before cancelling them here — the
        subsequent cancel discards the handle, so the swap counters
        never see a phantom restore."""
        return self._swap_store[handle][1]

    def swap_in(self, handle: int):
        """Redeem a swap handle: returns ``(n_pages, payload)`` and drops
        the host copy (a resume restores into freshly allocated device
        pages, so the host bytes are dead afterwards)."""
        n_pages, payload = self._swap_store.pop(handle)
        self.swapped_in_pages += n_pages
        return n_pages, payload

    def swap_discard(self, handle: int) -> None:
        """Drop a parked payload without restoring it (request cancelled
        while waiting)."""
        self._swap_store.pop(handle, None)

    def host_put(self, digest: bytes, payload) -> None:
        """Spill one evicted page's bytes into the digest-keyed host
        prefix cache (LRU, capacity ``host_cache_pages``).  No-op when
        the tier is disabled."""
        if self.host_cache_pages <= 0:
            return
        self._host_cache[digest] = payload
        self._host_cache.move_to_end(digest)
        while len(self._host_cache) > self.host_cache_pages:
            self._host_cache.popitem(last=False)
        self.host_cache_spills += 1

    def host_contains(self, digest: bytes) -> bool:
        """Read-only host-cache membership probe.  Unlike
        :meth:`host_lookup` this never pops the entry — the replica
        router walks whole digest chains across every replica to score
        prefix affinity, and a probing read must not consume pages the
        winning replica will restore at admission."""
        return digest in self._host_cache

    def host_lookup(self, digest: bytes):
        """Pop a spilled page's payload by digest (None on miss).  The
        caller re-uploads it into a fresh device page and re-registers
        the digest, so the host copy is consumed, not shared."""
        payload = self._host_cache.pop(digest, None)
        if payload is not None:
            self.host_cache_hits += 1
        return payload

    def page_shared(self, blk: int) -> bool:
        """True when writing into ``blk`` needs copy-on-write first:
        other tables hold it (ref > 1) or it backs a hash-index entry
        that a future prefix match could attach."""
        blk = self._validate(blk)
        if self._refs[blk] > 1:
            return True
        digest = self._page_hash[blk]
        return digest is not None and self._hash_index.get(digest) == blk

    def utilization(self) -> Dict[str, float]:
        """Pool accounting snapshot.  Always includes page counts (every
        page is in exactly one of in-use / cached / free) and the prefix
        cache's hit/evict/COW counters; when ``page_bytes_per_shard`` is
        known, also the per-shard byte view an operator sizes cluster
        memory with — both the raw pool (``pool_bytes_per_shard``,
        including the reserved null page) and the usable pool
        (``usable_pool_bytes_per_shard``, excluding it), so the byte
        fields and the null-block-excluding ``utilization`` ratio are
        explicitly consistent."""
        usable = self.num_blocks - 1  # null block excluded
        out = {
            "num_blocks": self.num_blocks,
            "usable_blocks": usable,
            "block_size": self.block_size,
            "in_use": self._in_use,
            "cached": self.num_cached,
            "free": self.num_free,
            "utilization": self._in_use / max(usable, 1),
            "peak_in_use": self.peak_in_use,
            "total_allocated": self.total_allocated,
            "total_freed": self.total_freed,
            "cache_hits": self.cache_hits,
            "cache_evictions": self.cache_evictions,
            "cow_copies": self.cow_copies,
            "num_shards": self.num_shards,
            # capacity tiers (DESIGN.md §13): device pages are the hot
            # tier; the host holds swapped-out request payloads plus the
            # digest-keyed spill cache
            "kv_dtype": self.kv_dtype,
            "device_pages": self._in_use + self.num_cached + self.num_free,
            "host_pages": self.host_pages,
            "swapped_out_pages": self.swapped_out_pages,
            "swapped_in_pages": self.swapped_in_pages,
            "host_cache_capacity_pages": self.host_cache_pages,
            "host_cache_pages": len(self._host_cache),
            "host_cache_hits": self.host_cache_hits,
            "host_cache_spills": self.host_cache_spills,
        }
        if self.page_bytes_per_shard is not None:
            pb = self.page_bytes_per_shard
            out["page_bytes_per_shard"] = pb
            out["pool_bytes_per_shard"] = self.num_blocks * pb
            out["usable_pool_bytes_per_shard"] = usable * pb
            out["in_use_bytes_per_shard"] = self._in_use * pb
            out["host_bytes_per_shard"] = self.host_pages * pb
            if self.fp_page_bytes_per_shard is not None:
                # what the same pool would cost unquantized — the int8
                # capacity multiplier at fixed bytes is fp/quantized
                fpb = self.fp_page_bytes_per_shard
                out["fp_page_bytes_per_shard"] = fpb
                out["fp_pool_bytes_per_shard"] = self.num_blocks * fpb
                out["quantized_bytes_ratio"] = pb / fpb
        return out


class BlockTable:
    """Logical-to-physical page map for one request.

    ``shared`` counts the leading pages attached from the prefix cache
    (:meth:`fork_from_prefix`): those may be referenced by other tables
    or by the hash index, so the engine must :meth:`cow` one before any
    write lands in it.  Pages the request allocates itself (``ensure``)
    are always private.
    """

    def __init__(self, allocator: BlockAllocator, max_blocks: int):
        self.allocator = allocator
        self.max_blocks = max_blocks
        self.blocks: List[int] = []
        self.shared = 0

    @property
    def capacity_tokens(self) -> int:
        """Hard per-request cap (table width, not current allocation)."""
        return self.max_blocks * self.allocator.block_size

    def fork_from_prefix(self, blocks: List[int]) -> None:
        """Share a matched prefix's full pages by incref (no data moves).

        ``blocks`` are pages found through the allocator's hash index;
        each is attached (resurrected from the cache if zero-ref) and
        becomes a leading *shared* entry of this table.
        """
        assert not self.blocks, "fork_from_prefix needs an empty table"
        assert len(blocks) <= self.max_blocks, \
            "matched prefix exceeds block-table width"
        for blk in blocks:
            self.allocator.attach(blk)
        self.blocks = list(blocks)
        self.shared = len(blocks)

    def cow(self, idx: int, new_blk: int) -> None:
        """Swap shared page ``blocks[idx]`` for the private copy
        ``new_blk`` (the engine has already copied the page on-device via
        ``ops.copy_pages``).  The old page loses this table's reference —
        dropping back to the cache or to its other holders.  ``shared``
        shrinks to ``idx``: a caller COWing several pages of one write
        range must walk against the *original* count (the engine
        snapshots it), and must copy every shared page it will write —
        in practice only the last one, since writes are append-only and
        pages before the write position are never touched again."""
        assert 0 <= idx < len(self.blocks)
        old = self.blocks[idx]
        self.blocks[idx] = int(new_blk)
        self.shared = min(self.shared, idx)
        self.allocator.cow_copies += 1
        self.allocator.decref([old])

    def ensure(self, n_tokens: int) -> bool:
        """Grow the table to cover ``n_tokens`` positions.

        Returns False (allocating nothing further) when the pool is
        exhausted; the caller decides whether to preempt.  Exceeding the
        table width itself is a programming error — engines must finish a
        request before ``capacity_tokens``.
        """
        bs = self.allocator.block_size
        need = -(-n_tokens // bs)  # ceil
        assert need <= self.max_blocks, "request exceeds block-table width"
        while len(self.blocks) < need:
            blk = self.allocator.allocate()
            if blk is None:
                return False
            self.blocks.append(blk)
        return True

    def release(self) -> None:
        self.allocator.decref(self.blocks)
        self.blocks = []
        self.shared = 0

    def as_row(self) -> np.ndarray:
        """Padded (max_blocks,) int32 row; unallocated entries -> null."""
        row = np.full((self.max_blocks,), NULL_BLOCK, np.int32)
        row[:len(self.blocks)] = self.blocks
        return row
