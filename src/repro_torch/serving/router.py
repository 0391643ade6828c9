"""Data-parallel replica router: N paged engines behind one facade.  The
counterpart of ``repro/serving/router.py``.

Serving heavy traffic needs N engines behind a router — the paper's
P2RAC framing of a platform layer that sits between the user and the
cloud and manages cluster resources elastically.  :class:`ReplicaRouter`
runs multiple :class:`~repro_torch.serving.engine.PagedServingEngine`
replicas and speaks the engine's own driving contract (``submit`` /
``cancel`` / ``step_begin`` / ``step_end`` / ``finished`` /
``run_to_completion``), so
:class:`~repro_torch.serving.frontend.ServingFrontend` drives a fleet
exactly as it drives one engine — open-loop traffic fans out across
replicas transparently.  Replicas may share one card and one weight set:
``step_begin`` launches every replica's tick before any ``step_end``
waits for one.

Placement is two-tier:

* **prefix affinity** (default): the router probes every replica's
  digest-indexed page cache — device-resident zero-ref pages *and* the
  host prefix cache — by walking the prompt's
  :func:`~repro_torch.serving.blocks.page_digest` chain read-only (no
  admission, no refcount changes).  The request goes to the replica
  holding the longest cached prefix, provided that replica is under the
  anti-herd ``pressure_cap``; otherwise
* **pressure balancing**: least-loaded replica by
  ``in_use_page_fraction + queue_depth / max_slots`` — built from the
  same ``queue_depth`` / ``free_page_fraction`` snapshot
  ``engine.metrics()`` exposes (cached zero-ref pages are evictable on
  demand, so they count as free, not load).

``routing="rr"`` is the round-robin baseline.

Elasticity reuses the fault-tolerance machinery: ``resize(n)`` grows the
fleet with factory-built replicas or drains doomed ones, re-routing
every in-flight request — generated-so-far tokens are carried and the
request is resubmitted as ``prompt + carried`` with the remaining token
budget, so greedy decoding makes the continuation byte-identical to an
uninterrupted run.  Swap-tier payloads and device-resident digest pages
(CPU torch tensors, ``(L, n_pages, ...)`` a pool) migrate into the
survivor's host prefix cache (when it has one), so a re-routed request
re-admits warm instead of re-prefilling.  Injected replica preemption
(:class:`~repro_torch.ft.preemption.PreemptionSchedule`) kills a live
replica mid-traffic and replaces it with a fresh factory-built one —
zero dropped requests either way.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.ft.preemption import PreemptionSchedule, SimulatedPreemption
from repro_torch.serving.blocks import page_digest

__all__ = ["ReplicaRouter", "RoutedRequest", "FinishedProxy"]


@dataclass
class RoutedRequest:
    """Router-side record of one live request and where it lives now."""
    req_id: int                       # router-global id
    prompt: np.ndarray                # original prompt (never mutated)
    max_new_tokens: int               # original budget
    replica: int                      # current home replica index
    engine_id: int                    # req_id on that replica's engine
    carried: List[int] = field(default_factory=list)  # tokens generated
    #                                   on replicas it was re-routed off
    moves: int = 0                    # re-routes survived
    affinity_tokens: int = 0          # digest-probe match at placement


@dataclass
class FinishedProxy:
    """Finished-request record the router presents to the front end.

    Mirrors the fields :class:`ServingFrontend._harvest_finished` reads
    from ``engine.finished`` values (``generated`` / ``oom`` /
    ``cancelled``), with ``generated`` spliced across every replica the
    request touched.  ``ttft``/``latency`` are stashed from the final
    replica's scheduler stats before ``clear_finished()`` forgets them
    (None for re-routed requests — their first token predates the final
    replica's record, so per-replica timings would lie)."""
    req_id: int
    generated: List[int]
    done: bool = True
    oom: bool = False
    cancelled: bool = False
    replica: int = 0
    moves: int = 0
    ttft: Optional[float] = None
    latency: Optional[float] = None


class _FleetScheduler:
    """Scheduler facade: the few attributes ``ServingFrontend`` and
    drain loops read (``clock`` / ``has_waiting`` / ``waiting``),
    aggregated over the fleet."""

    def __init__(self, router: "ReplicaRouter"):
        self._router = router

    @property
    def clock(self):
        return self._router.replicas[0].scheduler.clock

    @property
    def has_waiting(self) -> bool:
        return any(e.scheduler.has_waiting for e in self._router.replicas)

    @property
    def waiting(self) -> List:
        out: List = []
        for e in self._router.replicas:
            out.extend(e.scheduler.waiting)
        return out


class ReplicaRouter:
    """Run ``replicas`` factory-built engines behind the engine contract.

    Args:
        factory: ``factory(i) -> PagedServingEngine`` builds replica
            ``i``.  Called eagerly for the initial fleet and again on
            ``resize``-up / replica replacement after an injected
            preemption.  Replicas must be homogeneous in capacity
            (``block_size`` / ``num_blocks`` / ``capacity_tokens`` /
            ``max_slots``) and in device type — checked at construction
            and on every replacement, so a replica never runs on the CPU
            beside card replicas — and, for deterministic virtual-time
            tests, share one clock.
        replicas: initial fleet size (>= 1).
        routing: ``"affinity"`` (two-tier prefix-affinity placement,
            default) or ``"rr"`` (round-robin baseline).
        pressure_cap: anti-herd bound — an affinity hit is only honoured
            while the target replica's pressure
            (``in_use_page_fraction + queue_depth / max_slots``)
            stays under this cap; above it the request falls back to
            pressure balancing so one hot prefix cannot starve the
            fleet.
        preemption: optional
            :class:`~repro_torch.ft.preemption.PreemptionSchedule` over *tick*
            numbers; when it fires, replica ``tick % len(replicas)`` is
            killed and replaced mid-traffic (in-flight requests
            re-routed, never dropped).
        retire: optional hook called with each engine that leaves the
            fleet (resize-down or preemption kill) after it has been
            fully evacuated — tests recycle engines through it to avoid
            re-jitting.
    """

    ROUTING = ("rr", "affinity")

    def __init__(self, factory: Callable[[int], object], replicas: int = 2,
                 *, routing: str = "affinity", pressure_cap: float = 1.5,
                 preemption: Optional[PreemptionSchedule] = None,
                 retire: Optional[Callable[[object], None]] = None):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if routing not in self.ROUTING:
            raise ValueError(f"routing must be one of {self.ROUTING}, "
                             f"got {routing!r}")
        self._factory = factory
        self.routing = routing
        self.pressure_cap = float(pressure_cap)
        self.preemption = preemption
        self.retire = retire
        self.replicas: List = [factory(i) for i in range(replicas)]
        self._check_homogeneous()
        self.scheduler = _FleetScheduler(self)
        self._pending: Optional[Dict[int, object]] = None
        self._next_id = 0
        self._live: Dict[int, RoutedRequest] = {}
        self._by_eid: List[Dict[int, int]] = [dict() for _ in self.replicas]
        self.finished: Dict[int, FinishedProxy] = {}
        # fleet counters (metrics())
        self.ticks = 0
        self._rr_next = 0
        self.placements = {"affinity": 0, "balanced": 0, "rr": 0}
        self.affinity_hit_tokens = 0
        self.rerouted_total = 0
        self.migrated_pages = 0
        self.replica_failures = 0
        self.resizes = 0
        self._finished_total = 0

    # ------------------------------------------------------------------
    # capacity facade (ServingFrontend.submit validates against these)
    # ------------------------------------------------------------------
    def _check_homogeneous(self) -> None:
        e0 = self.replicas[0]
        for i, e in enumerate(self.replicas):
            if (e.block_size, e.num_blocks, e.capacity_tokens,
                    e.max_slots) != (e0.block_size, e0.num_blocks,
                                     e0.capacity_tokens, e0.max_slots):
                raise ValueError(
                    f"replica {i} capacity differs from replica 0; the "
                    f"router requires a homogeneous fleet (affinity "
                    f"probing keys pages by block_size-chunked digests)")
            if e.device.type != e0.device.type:
                raise ValueError(
                    f"replica {i} runs on {e.device}, replica 0 on "
                    f"{e0.device}; the router requires a homogeneous fleet")

    @property
    def block_size(self) -> int:
        return self.replicas[0].block_size

    @property
    def num_blocks(self) -> int:
        return self.replicas[0].num_blocks

    @property
    def capacity_tokens(self) -> int:
        return self.replicas[0].capacity_tokens

    @property
    def max_slots(self) -> int:
        return self.replicas[0].max_slots

    @property
    def active(self) -> int:
        return sum(e.active for e in self.replicas)

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def _pressure(self, eng) -> float:
        # in-use pages are real load; zero-ref cached pages are not (the
        # allocator evicts them on demand), so a warm cache never makes
        # a replica look busy — only held pages and queued requests do
        held = eng.alloc.num_in_use / max(1, eng.num_blocks - 1)
        return held + len(eng.scheduler.waiting) / eng.max_slots

    def _probe(self, eng, prompt: np.ndarray) -> int:
        """Tokens of ``prompt`` whose page-digest chain the replica can
        serve from cache (device zero-ref pages or host prefix cache) —
        a read-only walk: no admission, no refcounts touched."""
        if not eng.prefix_cache:
            return 0
        bs = eng.block_size
        digest = b""
        matched = 0
        # stop one page short of the full prompt: admission always
        # leaves >= 1 token to prefill, so the last page never matters
        for start in range(0, prompt.size - 1, bs):
            chunk = prompt[start:start + bs]
            if chunk.size < bs:
                break
            digest = page_digest(digest, chunk)
            if eng.alloc.lookup(digest) is None \
                    and not eng.alloc.host_contains(digest):
                break
            matched += bs
        return matched

    def _place(self, prompt: np.ndarray,
               candidates: Optional[List[int]] = None) -> int:
        idx = candidates if candidates is not None \
            else list(range(len(self.replicas)))
        if self.routing == "rr":
            i = idx[self._rr_next % len(idx)]
            self._rr_next += 1
            self.placements["rr"] += 1
            return i
        press = {i: self._pressure(self.replicas[i]) for i in idx}
        best, best_m = None, 0
        for i in idx:
            m = self._probe(self.replicas[i], prompt)
            if m > best_m and press[i] <= self.pressure_cap:
                best, best_m = i, m
        if best is not None:
            self.placements["affinity"] += 1
            self.affinity_hit_tokens += best_m
            return best
        i = min(idx, key=lambda j: (press[j], j))
        self.placements["balanced"] += 1
        return i

    # ------------------------------------------------------------------
    # request lifecycle (engine contract)
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int) -> int:
        """Place and queue a request; returns a router-global req_id."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        i = self._place(prompt)
        eid = self.replicas[i].submit(prompt, max_new_tokens)
        rid = self._next_id
        self._next_id += 1
        self._live[rid] = RoutedRequest(rid, prompt, int(max_new_tokens),
                                        i, eid)
        self._by_eid[i][eid] = rid
        return rid

    def cancel(self, req_id: int) -> bool:
        """Abort a request wherever it currently lives — idempotent:
        unknown, finished, already-cancelled, or stale (re-routed away
        and since completed) ids return False instead of raising."""
        rec = self._live.get(req_id)
        if rec is None:
            return False
        took = self.replicas[rec.replica].cancel(rec.engine_id)
        self._harvest(rec.replica)
        return bool(took)

    def _harvest(self, i: int) -> None:
        """Fold replica ``i``'s finished requests into the router's
        ``finished`` dict as :class:`FinishedProxy` records, stashing
        scheduler timings *before* ``clear_finished()`` forgets them."""
        eng = self.replicas[i]
        if not eng.finished:
            return
        for eid, req in eng.finished.items():
            rid = self._by_eid[i].pop(eid, None)
            if rid is None:
                continue    # submitted directly on the replica, not ours
            rec = self._live.pop(rid)
            st = eng.scheduler.stats.get(eid)
            fresh = st is not None and rec.moves == 0
            self.finished[rid] = FinishedProxy(
                req_id=rid, generated=rec.carried + list(req.generated),
                oom=req.oom, cancelled=req.cancelled, replica=i,
                moves=rec.moves,
                ttft=st.ttft if fresh else None,
                latency=st.latency if fresh else None)
            self._finished_total += 1
        eng.clear_finished()

    def clear_finished(self) -> Dict[int, List[int]]:
        out = {rid: p.generated for rid, p in self.finished.items()}
        self.finished.clear()
        return out

    # ------------------------------------------------------------------
    # tick fan-out
    # ------------------------------------------------------------------
    def step_begin(self) -> Dict[int, object]:
        """Launch one tick on every replica that has work; returns the
        pending handle for :meth:`step_end`.  Fires the injected
        preemption schedule (if any) at the tick boundary — the victim
        replica is evacuated and replaced *before* anything launches, so
        no in-flight dispatch is ever torn down."""
        if self._pending is not None:
            raise RuntimeError("step_begin() called with a tick already "
                               "in flight; call step_end() first")
        if self.preemption is not None:
            try:
                self.preemption.check(self.ticks)
            except SimulatedPreemption:
                self.fail_replica(self.ticks % len(self.replicas))
        self.ticks += 1
        pend: Dict[int, object] = {}
        for i, eng in enumerate(self.replicas):
            if eng.scheduler.has_waiting or eng.active:
                pend[i] = eng.step_begin()
        self._pending = pend
        return pend

    def step_end(self, pending: Optional[Dict[int, object]] = None
                 ) -> Dict[int, object]:
        """Sync every replica's tick; returns this tick's emitted tokens
        keyed by *router* req_id, then harvests finished requests."""
        if pending is None:
            pending = self._pending
        if pending is None or pending is not self._pending:
            raise RuntimeError("step_end() without a matching "
                               "step_begin()")
        self._pending = None
        emitted: Dict[int, object] = {}
        for i, handle in pending.items():
            got = self.replicas[i].step_end(handle)
            for eid, v in got.items():
                rid = self._by_eid[i].get(eid)
                if rid is not None:
                    emitted[rid] = v
        for i in range(len(self.replicas)):
            self._harvest(i)
        return emitted

    def step(self) -> Dict[int, object]:
        return self.step_end(self.step_begin())

    def _state_fingerprint(self):
        return (tuple(e._state_fingerprint() for e in self.replicas),
                len(self.finished), len(self._live))

    def run_to_completion(self, max_steps: int = 10_000
                          ) -> Dict[int, List[int]]:
        """Drain every replica; returns {router req_id: generated}.
        Mirrors the engine's livelock proof: a repeated fleet
        fingerprint across emit-less steps means no replica can ever
        make progress."""
        last_fp = None
        for _ in range(max_steps):
            if not self.scheduler.has_waiting and self.active == 0:
                break
            if self.step():
                last_fp = None
                continue
            fp = self._state_fingerprint()
            if fp == last_fp:
                raise RuntimeError(
                    f"run_to_completion: no replica can make progress "
                    f"with {self.active} active and "
                    f"{len(self.scheduler.waiting)} waiting requests")
            last_fp = fp
        if self.scheduler.has_waiting or self.active:
            raise RuntimeError(f"run_to_completion: step budget "
                               f"exhausted after {max_steps} steps")
        return {rid: p.generated for rid, p in self.finished.items()}

    # ------------------------------------------------------------------
    # elasticity: resize / injected preemption
    # ------------------------------------------------------------------
    def _migrate_pages(self, chain: List[bytes],
                       payload: Optional[Dict[str, torch.Tensor]],
                       target) -> None:
        """Seed the target replica's host prefix cache with the evacuated
        request's full pages, keyed by its digest chain — re-admission
        then restores bytes instead of re-prefilling them."""
        if payload is None or not chain:
            return
        if not (target.prefix_cache and target.alloc.host_cache_pages > 0):
            return
        for j, digest in enumerate(chain):
            target.alloc.host_put(
                digest, {name: arr[:, j:j + 1]
                         for name, arr in payload.items()})
            self.migrated_pages += 1

    def _evacuate(self, i: int, survivors: List[int]) -> None:
        """Re-route every live request off replica ``i`` onto the
        surviving replicas.  Generated-so-far tokens are carried (the
        front end already streamed them) and the request resubmits as
        ``prompt + carried`` with the remaining budget — greedy decoding
        makes the continuation byte-identical.  Swap-tier payloads and
        device-resident pages migrate into the survivor's host cache."""
        if self._pending is not None:
            raise RuntimeError("cannot evacuate a replica while a tick "
                               "is in flight; call step_end() first")
        eng = self.replicas[i]
        self._harvest(i)
        live: List = [r for r in eng.slot_req if r is not None]
        live += list(eng.scheduler.waiting)
        live.sort(key=lambda r: r.req_id)    # admission order, FCFS-ish
        for req in live:
            rid = self._by_eid[i].pop(req.req_id, None)
            # harvest pages for migration before cancel releases them
            chain: List[bytes] = []
            payload = None
            ent = eng._swap_handles.get(req.req_id)
            if ent is not None:
                handle, _phase, _filled, chain = ent
                payload = eng.alloc.swap_peek(handle)
            else:
                for slot, r in enumerate(eng.slot_req):
                    if r is req:
                        chain = list(eng.slot_chain[slot])
                        if chain:
                            payload = eng._pages_to_host(
                                eng.tables[slot].blocks[:len(chain)])
                        break
            eng.cancel(req.req_id)
            eng.finished.pop(req.req_id, None)   # not terminal: re-routed
            eng.scheduler.forget(req.req_id)
            if rid is None:
                continue    # direct engine submit; dropped with replica
            rec = self._live[rid]
            rec.carried = rec.carried + list(req.generated)
            remaining = rec.max_new_tokens - len(rec.carried)
            assert remaining >= 1, "finished request left in a slot"
            prompt = rec.prompt if not rec.carried else np.concatenate(
                [rec.prompt, np.asarray(rec.carried, np.int32)])
            t = self._place(prompt, candidates=survivors)
            self._migrate_pages(chain, payload, self.replicas[t])
            rec.replica = t
            rec.engine_id = self.replicas[t].submit(prompt, remaining)
            rec.moves += 1
            self._by_eid[t][rec.engine_id] = rid
            self.rerouted_total += 1

    def resize(self, n: int) -> int:
        """Grow or shrink the fleet to ``n`` replicas mid-traffic.

        Growth appends factory-built replicas (they pick up new
        placements immediately).  Shrink evacuates the doomed replicas —
        every in-flight request re-routes onto a survivor with its
        stream intact — then drops them.  Returns the new size."""
        if n < 1:
            raise ValueError("resize: fleet must keep >= 1 replica")
        if self._pending is not None:
            raise RuntimeError("resize: a tick is in flight; call "
                               "step_end() first")
        cur = len(self.replicas)
        if n == cur:
            return n
        self.resizes += 1
        if n > cur:
            for i in range(cur, n):
                self.replicas.append(self._factory(i))
                self._by_eid.append({})
            self._check_homogeneous()
            return n
        survivors = list(range(n))
        for i in range(cur - 1, n - 1, -1):
            self._evacuate(i, survivors)
        doomed = self.replicas[n:]
        del self.replicas[n:]
        del self._by_eid[n:]
        if self.retire is not None:
            for e in doomed:
                self.retire(e)
        return n

    def fail_replica(self, i: int) -> None:
        """Simulate replica ``i`` preempted mid-traffic: evacuate its
        requests onto the rest of the fleet, then replace it with a
        fresh factory-built engine (fleet size is unchanged — this is
        the spot-instance story, not a resize)."""
        if not 0 <= i < len(self.replicas):
            raise IndexError(f"no replica {i}")
        if len(self.replicas) == 1:
            raise RuntimeError("cannot fail the only replica: its "
                               "requests have nowhere to re-route")
        survivors = [j for j in range(len(self.replicas)) if j != i]
        self._evacuate(i, survivors)
        dead = self.replicas[i]
        self.replicas[i] = self._factory(i)
        self._by_eid[i] = {}
        self._check_homogeneous()
        self.replica_failures += 1
        if self.retire is not None:
            self.retire(dead)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def metrics(self) -> Dict[str, object]:
        """Fleet rollup + per-replica ``engine.metrics()`` reports."""
        per = [e.metrics() for e in self.replicas]
        qd = sum(m["queue_depth"] for m in per)
        fpf = sum(m["free_page_fraction"] for m in per) / len(per)
        return {
            "fleet": {
                "replicas": len(self.replicas),
                "routing": self.routing,
                "pressure_cap": self.pressure_cap,
                "ticks": self.ticks,
                "requests": self._next_id,
                "finished": self._finished_total,
                "in_flight": len(self._live),
                "queue_depth": qd,
                "free_page_fraction": fpf,
                "placements": dict(self.placements),
                "affinity_hit_tokens": self.affinity_hit_tokens,
                "rerouted": self.rerouted_total,
                "migrated_pages": self.migrated_pages,
                "replica_failures": self.replica_failures,
                "resizes": self.resizes,
            },
            "replicas": per,
        }

    def dump_trace(self, path) -> str:
        """Write one merged JSONL trace: every replica's meta record and
        time-sorted tick/span events, each tagged ``"replica": i`` so
        ``tools/tracestats.py`` can split the stream and re-run the
        per-replica tick-invariant checks.  JSONL only (a merged Chrome
        timeline would interleave unrelated pids misleadingly)."""
        import json

        from repro_torch.obs.trace import _jsonable

        path = str(path)
        if path.endswith(".json"):
            raise ValueError("merged router traces are JSONL-only; use "
                             "a .jsonl path (per-replica Chrome "
                             "timelines: replicas[i].dump_trace())")
        records: List[Dict] = []
        for i, eng in enumerate(self.replicas):
            if not eng.telemetry.enabled:
                raise RuntimeError(f"replica {i} was built with "
                                   f"telemetry=False; nothing to dump")
            tel = eng.telemetry
            meta = tel._meta(eng.metrics())
            meta["replica"] = i
            records.append(meta)
            for ev in list(tel.ticks.items()) + list(tel.spans.items()):
                ev = dict(ev)
                ev["replica"] = i
                records.append(ev)
        metas = [r for r in records if r["type"] == "meta"]
        events = sorted((r for r in records if r["type"] != "meta"),
                        key=lambda e: (e["t"], e["replica"]))
        with open(path, "w") as f:
            for rec in metas + events:
                f.write(json.dumps(rec, default=_jsonable) + "\n")
        return "jsonl"
