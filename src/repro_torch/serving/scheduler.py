"""Request scheduling for the paged engine: FCFS queue + preemption + stats.

The scheduler owns the waiting queue, per-request accounting, and — for
the unified tick (DESIGN.md §8) — the per-tick prefill/decode token split
(:meth:`FCFSScheduler.plan_tick`): every decoding request is always
granted its one token, and whatever remains of the engine's
``token_budget`` is granted to prefilling requests in admission (FCFS)
order, up to ``prefill_chunk`` each.  The engine owns slots and blocks.
Preemption policy decides which in-flight request gives its pages back
when the pool runs dry mid-decode:

    "longest" — evict the request holding the most cache (frees the most
                pages per eviction; classic evict-longest)
    "newest"  — evict the most recently admitted request (LIFO; protects
                FCFS seniority, so old requests never starve)

Preempted requests are requeued at the *front* of the waiting queue and
recomputed on re-admission (their accumulated tokens are re-prefilled);
greedy decoding makes recomputation token-exact.

Telemetry (DESIGN.md §10): every lifecycle event also feeds an attached
:class:`repro_torch.obs.ServingTelemetry` — request spans (submit -> admit ->
first_token -> finish/preempt) into the trace ring, and TTFT / latency /
inter-token / queue-wait samples into its fixed-bucket histograms, which
is where :meth:`FCFSScheduler.summary`'s ``p50_*``/``p99_*`` fields come
from.  A scheduler constructed without one gets a *disabled* instance:
the clock-read pattern is then exactly the historical one (no per-token
reads), and the percentile fields report None.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.obs import ServingTelemetry


@dataclass
class RequestStats:
    req_id: int
    prompt_tokens: int
    submitted_at: float
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    last_token_at: Optional[float] = None   # feeds inter-token histogram
    generated_tokens: int = 0
    preemptions: int = 0

    @property
    def ttft(self) -> Optional[float]:
        """Submit-to-first-token latency (queueing + prefill)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def latency(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    @property
    def decode_tokens_per_s(self) -> Optional[float]:
        if self.finished_at is None or self.first_token_at is None:
            return None
        dt = self.finished_at - self.first_token_at
        if dt <= 0 or self.generated_tokens <= 1:
            return None
        return (self.generated_tokens - 1) / dt


class FCFSScheduler:
    """First-come-first-served admission with a preemption policy."""

    POLICIES = ("longest", "newest")

    def __init__(self, *, preemption_policy: str = "longest",
                 clock: Callable[[], float] = time.perf_counter,
                 telemetry: Optional[ServingTelemetry] = None):
        assert preemption_policy in self.POLICIES, preemption_policy
        self.preemption_policy = preemption_policy
        self.clock = clock
        # None -> a disabled instance: summary() keeps its percentile
        # keys (as None) and the lifecycle hooks read the clock exactly
        # as often as they historically did (fake-clock tests rely on it)
        self.telemetry = telemetry if telemetry is not None else \
            ServingTelemetry(enabled=False, capacity=1, clock=clock)
        self.waiting: Deque[Any] = deque()
        self.stats: Dict[int, RequestStats] = {}
        self._admit_seq = 0
        self._admitted_order: Dict[int, int] = {}   # latest admission
        self._first_admit: Dict[int, int] = {}      # seniority (never moves)
        # Running aggregates, folded in at each lifecycle event so that
        # summary() survives forget() of finished requests (a long-lived
        # engine drops per-request records without losing its history).
        self._submitted_total = 0
        self._finished_total = 0
        self._finished_tokens = 0
        self._preempt_total = 0
        self._cancelled_total = 0
        self._ttft_sum = 0.0
        self._ttft_n = 0
        self._latency_sum = 0.0
        self._latency_n = 0
        self._span_start: Optional[float] = None   # earliest finished submit
        self._span_end: Optional[float] = None     # latest finish

    # -- queue ---------------------------------------------------------
    def submit(self, req, prompt_tokens: int) -> None:
        """Enqueue a new request (tail of the FCFS line) and open its
        accounting record."""
        st = RequestStats(req.req_id, prompt_tokens,
                          submitted_at=self.clock())
        self.stats[req.req_id] = st
        self._submitted_total += 1
        self.waiting.append(req)
        self.telemetry.span(req.req_id, "submit", st.submitted_at,
                            prompt_tokens=prompt_tokens)

    def requeue_front(self, req) -> None:
        """Preempted request: back to the head of the line (FCFS)."""
        self.waiting.appendleft(req)

    @property
    def has_waiting(self) -> bool:
        """True while any request is queued for admission."""
        return bool(self.waiting)

    def next_request(self):
        """Pop the head of the line (None when the queue is empty)."""
        return self.waiting.popleft() if self.waiting else None

    # -- lifecycle events ----------------------------------------------
    def on_admit(self, req_id: int) -> None:
        """Record an admission: first-admission time + recency order
        (the ``newest`` preemption policy evicts by this order).  Spans:
        a re-admission after preemption is an ``admit`` with
        ``resume=True`` (the request's KV is being recomputed)."""
        st = self.stats[req_id]
        tel = self.telemetry
        if tel.enabled:
            now = self.clock()
            if st.admitted_at is None:
                st.admitted_at = now
                tel.queue_wait_s.record(now - st.submitted_at)
                tel.span(req_id, "admit", now, resume=False)
            else:
                tel.span(req_id, "admit", now, resume=True)
        elif st.admitted_at is None:
            st.admitted_at = self.clock()
        # latest order feeds the "newest" eviction policy (re-admission
        # refreshes it); first-admission order is the FCFS seniority
        # plan_tick grants prefill budget by — a preempted request must
        # NOT drop to the back of the token line on re-admission
        self._first_admit.setdefault(req_id, self._admit_seq)
        self._admitted_order[req_id] = self._admit_seq
        self._admit_seq += 1

    def on_token(self, req_id: int) -> None:
        """Record one generated token: the first stamps TTFT (and its
        histogram sample + span); later ones feed the inter-token
        latency histogram when telemetry is enabled."""
        st = self.stats[req_id]
        st.generated_tokens += 1
        tel = self.telemetry
        if tel.enabled:
            now = self.clock()
            if st.first_token_at is None:
                st.first_token_at = now
                tel.ttft_s.record(now - st.submitted_at)
                tel.span(req_id, "first_token", now)
            elif st.last_token_at is not None:
                tel.inter_token_s.record(now - st.last_token_at)
            st.last_token_at = now
        elif st.first_token_at is None:
            st.first_token_at = self.clock()

    def on_preempt(self, req_id: int) -> None:
        """Count an eviction.  generated_tokens stays: a preempted request
        keeps its tokens and only re-prefills KV on re-admission; nothing
        is emitted twice."""
        self.stats[req_id].preemptions += 1
        self._preempt_total += 1
        if self.telemetry.enabled:
            self.telemetry.span(req_id, "preempt", self.clock())

    def on_cancel(self, req_id: int) -> None:
        """Record an aborted request.  Deliberately does NOT fold into the
        latency/TTFT aggregates — a request killed mid-flight would skew
        them low — but the span lands in the trace so tracestats can pair
        it as the request's terminal event."""
        self._cancelled_total += 1
        if self.telemetry.enabled:
            self.telemetry.span(req_id, "cancel", self.clock())

    def on_finish(self, req_id: int) -> None:
        """Stamp completion time and fold the request into the running
        aggregates (so ``summary()`` survives a later ``forget()``)."""
        st = self.stats[req_id]
        st.finished_at = self.clock()
        self._finished_total += 1
        self._finished_tokens += st.generated_tokens
        if st.ttft is not None:
            self._ttft_sum += st.ttft
            self._ttft_n += 1
        if st.latency is not None:
            self._latency_sum += st.latency
            self._latency_n += 1
        self._span_start = (st.submitted_at if self._span_start is None
                            else min(self._span_start, st.submitted_at))
        self._span_end = (st.finished_at if self._span_end is None
                          else max(self._span_end, st.finished_at))
        tel = self.telemetry
        if tel.enabled:
            if st.latency is not None:
                tel.latency_s.record(st.latency)
            tel.span(req_id, "finish", st.finished_at,
                     generated_tokens=st.generated_tokens)

    def forget(self, req_id: int) -> None:
        """Drop a finished request's accounting (bounds memory when a
        long-lived engine clears its finished set)."""
        self.stats.pop(req_id, None)
        self._admitted_order.pop(req_id, None)
        self._first_admit.pop(req_id, None)

    # -- unified-tick token split ---------------------------------------
    def plan_tick(self, token_budget: Optional[int],
                  decode_slots: List[int],
                  prefill: List[Tuple[int, int, int]],
                  chunk: int, draft: Optional[List[Tuple[int, int, int]]]
                  = None):
        """Split one unified tick's token budget between phases.

        decode_slots: slots decoding this tick — each costs one token and
            is ALWAYS granted (decodes never stall behind prompts; the
            effective budget floor is the decode count).
        prefill: ``[(slot, req_id, need), ...]`` for prefilling slots
            (``need`` = prompt tokens still to stream in — with the
            engine's prefix cache on this is the *uncached* tail only:
            prefill starts after the matched prefix, so cached tokens
            are never charged against the budget and a warm-hit
            admission is effectively free).
        chunk: per-request per-tick prefill ceiling (``prefill_chunk``).
        draft: ``[(slot, req_id, want), ...]`` speculative draft-token
            requests from decoding slots (DESIGN.md §11); ``want`` is
            the drafter's proposal length (already capped at the
            engine's ``draft_k``).  Drafted tokens are charged against
            the budget AFTER prefill chunks: speculation spends *spare*
            dispatch capacity and never starves a prompt of its chunk.
            ``None`` (the non-speculative engine) keeps the historical
            single-value return.

        Returns ``{slot: granted_prefill_tokens}`` (only entries > 0)
        when ``draft`` is None; otherwise the pair
        ``(prefill_grants, draft_grants)`` with the same shape each.
        Remaining budget after decodes goes to prefilling requests in
        *first*-admission order (FCFS — the earliest-admitted prompt
        finishes streaming first, and a preempted request keeps its
        seniority on re-admission), up to ``chunk`` each; whatever is
        left after that is granted to drafts, same order, up to ``want``
        each.  ``token_budget=None`` means unbounded: every prefilling
        request gets a full chunk (reproducing the legacy two-dispatch
        schedule token for token) and every draft its full ``want``.
        """
        grants: Dict[int, int] = {}
        remaining = (None if token_budget is None
                     else max(0, int(token_budget) - len(decode_slots)))
        order = sorted(prefill,
                       key=lambda t: self._first_admit.get(t[1], -1))
        for slot, _rid, need in order:
            n = min(chunk, need)
            if remaining is not None:
                n = min(n, remaining)
            if n > 0:
                grants[slot] = n
                if remaining is not None:
                    remaining -= n
        if draft is None:
            return grants
        draft_grants: Dict[int, int] = {}
        for slot, _rid, want in sorted(
                draft, key=lambda t: self._first_admit.get(t[1], -1)):
            n = int(want)
            if remaining is not None:
                n = min(n, remaining)
            if n > 0:
                draft_grants[slot] = n
                if remaining is not None:
                    remaining -= n
        return grants, draft_grants

    # -- preemption -----------------------------------------------------
    def choose_victim(self, candidates: List[Tuple[int, int, int]]
                      ) -> Optional[int]:
        """Pick a slot to evict.  candidates: [(slot, req_id, n_blocks)].

        Returns the chosen slot index, or None when there is nothing to
        evict (the caller then fails the allocation instead).
        """
        if not candidates:
            return None
        if self.preemption_policy == "longest":
            return max(candidates, key=lambda c: (c[2], c[1]))[0]
        # newest: latest admission order wins the eviction
        return max(candidates,
                   key=lambda c: self._admitted_order.get(c[1], -1))[0]

    # -- reporting ------------------------------------------------------
    @property
    def preemptions_total(self) -> int:
        """Evictions ever recorded (running total; survives forget)."""
        return self._preempt_total

    def summary(self) -> Dict[str, Any]:
        """Aggregate report over *all* requests ever seen.

        Built from running totals folded in at each lifecycle event, so
        ``forget()``-ing finished requests (``engine.clear_finished()``)
        never deflates throughput/latency history — a long-lived engine's
        ``tokens_per_s`` keeps meaning "over everything served so far".
        The ``mean_*`` keys keep their historical semantics; the
        ``p50_*``/``p90_*``/``p99_*`` fields come from the telemetry
        histograms (DESIGN.md §10) — also running (bucket counts only
        grow), and None when telemetry is disabled or nothing finished.
        """
        out: Dict[str, Any] = {
            "requests": self._submitted_total,
            "finished": self._finished_total,
            "waiting": len(self.waiting),
            # stable alias for the router's balancing signal — same key
            # on both engines' metrics() and here (see DESIGN.md §14)
            "queue_depth": len(self.waiting),
            "preemptions": self._preempt_total,
            "cancelled": self._cancelled_total,
        }
        if self._finished_total:
            out["mean_ttft_s"] = (self._ttft_sum / self._ttft_n
                                  if self._ttft_n else None)
            out["mean_latency_s"] = (self._latency_sum / self._latency_n
                                     if self._latency_n else None)
            out["generated_tokens"] = self._finished_tokens
            if self._span_end > self._span_start:
                out["tokens_per_s"] = (self._finished_tokens
                                       / (self._span_end - self._span_start))
            tel = self.telemetry
            out["p50_ttft_s"] = tel.ttft_s.percentile(50)
            out["p90_ttft_s"] = tel.ttft_s.percentile(90)
            out["p99_ttft_s"] = tel.ttft_s.percentile(99)
            out["p50_latency_s"] = tel.latency_s.percentile(50)
            out["p99_latency_s"] = tel.latency_s.percentile(99)
            out["p50_inter_token_s"] = tel.inter_token_s.percentile(50)
            out["p99_inter_token_s"] = tel.inter_token_s.percentile(99)
            out["p50_queue_wait_s"] = tel.queue_wait_s.percentile(50)
            out["p99_queue_wait_s"] = tel.queue_wait_s.percentile(99)
        return out
