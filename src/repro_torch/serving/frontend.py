"""Open-loop async serving front end over :class:`PagedServingEngine` (or a
:class:`~repro_torch.serving.router.ReplicaRouter`): the counterpart of
``repro/serving/frontend.py``, with one repair (``drain`` below).

The source paper's P2RAC sits *between* the analyst and the cluster: you
``submit`` work, the platform schedules it, you ``monitor``/``retrieve``
results on your own clock.  :class:`ServingFrontend` is that layer for
the serving stack — the engine keeps its synchronous tick, the front end
owns arrival timing, request identity, streaming, cancellation, and
drain (DESIGN.md §12):

  * ``submit(prompt, max_tokens, at=...) -> req_id`` — requests enter a
    time-ordered arrival queue; they reach the *engine* only once the
    front-end clock passes their arrival time, so scheduler queue-wait
    and TTFT measure real queueing, not pre-staging.
  * ``stream(req_id)`` — a generator yielding tokens as the engine
    produces them, driving the serving loop cooperatively underneath.
  * ``cancel(req_id)`` — abort anywhere in the lifecycle: before
    arrival, waiting in the scheduler queue, or mid-prefill/mid-decode
    (pages go back to the pool, the slot frees immediately).
  * ``drain()`` — serve everything (jumping an idle engine forward to
    the next arrival) and return the finished streams.

**Dispatch double-buffering.**  The engine tick splits into
``step_begin()`` (admit + plan + pack + launch, host-nonblocking) and
``step_end()`` (device sync + unpack).  The front end launches tick N,
then performs tick N+1's host-side admission work — popping due
arrivals into the scheduler queue — *inside* the window where the
device is busy, then syncs.  ``double_buffer=False`` does the same work
after the sync instead (token streams are identical either way; the
toggle exists so the overlap is measurable).

**Clocks.**  By default the front end shares the engine's wall clock
(arrivals paced by ``time.sleep``).  Tests and simulations pass a
:class:`VirtualClock` — time then advances only when the front end
jumps to the next arrival (plus ``virtual_tick_s`` per engine tick to
model service time), making every timing deterministic.  Build the
engine with ``clock=vclock`` so telemetry and scheduler stats live on
the same timeline.

**Progress.**  ``drain`` refuses to spin on a round that can make no
progress.  Besides tokens emitted and arrivals admitted, it counts the
front end's own progress (``settled_total``): a cancelled arrival
retired from the arrival queue, and a deferred cancel applied.  The JAX
front end counts only the first two, so two rounds that each retire a
cancelled arrival from an idle engine read as a livelock and raise.
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.serving.loadgen import TimedRequest, slo_report


class VirtualClock:
    """A manually advanced clock: call it for "now", ``sleep``/``advance``
    to move time forward (never backward).  Inject into both the engine
    (``clock=``) and the front end for deterministic open-loop tests —
    device work then takes zero virtual time unless the front end's
    ``virtual_tick_s`` models it."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("time cannot run backward")
        self.t += dt

    def advance_to(self, t: float) -> None:
        self.t = max(self.t, float(t))

    def sleep(self, dt: float) -> None:
        """Drop-in for ``time.sleep`` on the virtual timeline."""
        self.advance(max(0.0, dt))


@dataclass
class FrontendRequest:
    """Front-end-side request record (the engine has its own)."""
    req_id: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_t: float
    engine_id: Optional[int] = None      # None until it reaches the engine
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    oom: bool = False
    first_token_t: Optional[float] = None
    finished_t: Optional[float] = None


class ServingFrontend:
    """Async request server over a :class:`PagedServingEngine`.

    Single-threaded and cooperative: ``stream``/``drain`` drive the
    engine tick loop inline, overlapping host admission with the
    in-flight device dispatch (``double_buffer``).  Front-end req_ids
    are independent of engine req_ids (the engine numbers requests by
    *arrival*, the front end by *submission*).
    """

    def __init__(self, engine, *, clock=None, sleep=None,
                 double_buffer: bool = True,
                 virtual_tick_s: Optional[float] = None):
        self.engine = engine
        self.clock = clock if clock is not None else engine.scheduler.clock
        if sleep is None:
            sleep = (self.clock.sleep if isinstance(self.clock, VirtualClock)
                     else time.sleep)
        self.sleep = sleep
        self.double_buffer = double_buffer
        if virtual_tick_s is not None \
                and not isinstance(self.clock, VirtualClock):
            raise ValueError("virtual_tick_s models per-tick service time "
                             "on a VirtualClock; it is meaningless on a "
                             "wall clock")
        self.virtual_tick_s = virtual_tick_s
        self._arrivals: List = []            # heap of (t, req_id)
        self._reqs: Dict[int, FrontendRequest] = {}
        self._by_engine: Dict[int, FrontendRequest] = {}
        self._cancel_q: List[FrontendRequest] = []
        self._fresh: Dict[int, List[int]] = {}   # finished, not collected
        self._next_id = 0
        # progress/overlap accounting (report() exposes these)
        self.rounds = 0
        self.emitted_total = 0
        self.admitted_total = 0
        self.settled_total = 0      # cancelled arrivals retired, cancels
        #                             applied: front-end-only progress
        self.overlap_admitted = 0   # arrivals admitted inside the window

    # -- submission ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *,
               at: Optional[float] = None) -> int:
        """Register a request arriving at clock time ``at`` (default:
        now); returns its front-end req_id.  Shape validation happens
        here — a request the engine could never hold fails fast, not
        mid-drain."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        eng = self.engine
        written = prompt.size + int(max_new_tokens) - 1
        if prompt.size < 1 or max_new_tokens < 1 \
                or written > eng.capacity_tokens \
                or -(-written // eng.block_size) > eng.num_blocks - 1:
            raise ValueError(
                f"request (prompt {prompt.size}, max_new_tokens "
                f"{max_new_tokens}) cannot fit the engine (capacity "
                f"{eng.capacity_tokens} tokens, {eng.num_blocks - 1} "
                f"usable pages)")
        fid = self._next_id
        self._next_id += 1
        t = self.clock() if at is None else float(at)
        fr = FrontendRequest(fid, prompt, int(max_new_tokens), t)
        self._reqs[fid] = fr
        heapq.heappush(self._arrivals, (t, fid))
        return fid

    def submit_workload(self, workload: List[TimedRequest],
                        *, start: Optional[float] = None) -> List[int]:
        """Submit a loadgen workload with arrivals at ``start + r.t``
        (``start`` defaults to now); returns the front-end req_ids in
        workload order."""
        base = self.clock() if start is None else float(start)
        return [self.submit(r.prompt, r.max_new_tokens, at=base + r.t)
                for r in workload]

    # -- lifecycle -------------------------------------------------------
    def cancel(self, req_id: int) -> bool:
        """Abort a request at any lifecycle stage.  Returns True if the
        cancel took effect, False if the request is unknown or already
        finished.  Slot-held cancels are deferred past an in-flight
        tick (its tokens are packed into the running dispatch) and
        applied at the next safe point."""
        fr = self._reqs.get(req_id)
        if fr is None or fr.done or fr.cancelled:
            return False
        fr.cancelled = True
        if fr.engine_id is None:
            # still in the arrival queue: it simply never reaches the
            # engine (_pump_arrivals skips cancelled entries)
            fr.done = True
            return True
        self._cancel_q.append(fr)
        if self.engine._pending is None:
            self._apply_cancels()
        return True

    def stream(self, req_id: int) -> Iterator[int]:
        """Yield ``req_id``'s tokens as they are produced, driving the
        serving loop until the request finishes or is cancelled."""
        fr = self._reqs.get(req_id)
        if fr is None:
            raise KeyError(f"unknown req_id {req_id}")
        i = 0
        while True:
            while i < len(fr.tokens):
                yield fr.tokens[i]
                i += 1
            if fr.done:
                return
            if not self._round():
                raise RuntimeError(
                    f"stream({req_id}): engine went idle with the "
                    f"request unfinished — serving invariant broken")

    def drain(self, max_rounds: int = 1_000_000) -> Dict[int, List[int]]:
        """Serve until nothing is left: every arrival admitted (idle
        waits jump to the next arrival time), every request finished or
        cancelled.  Returns {req_id: tokens} for requests finished since
        the last collection.  Raises RuntimeError on livelock — a round
        that makes no progress twice in a row with an unchanged engine
        state can never make progress (the engine is deterministic), so
        drain refuses to spin.  Progress is a token emitted, an arrival
        admitted, or a cancelled arrival or a cancel settled by the front
        end itself: each request settles once, so the guard still fires
        for an engine that is truly stuck."""
        last_fp = None
        for _ in range(max_rounds):
            if not self._has_work():
                out, self._fresh = self._fresh, {}
                return out
            before = self._progress()
            self._round()
            if self._progress() != before:
                last_fp = None
                continue
            fp = self.engine._state_fingerprint()
            if fp == last_fp:
                raise RuntimeError(
                    f"drain(): no round can make progress with "
                    f"{self.engine.active} active and "
                    f"{len(self.engine.scheduler.waiting)} waiting "
                    f"engine requests — pool starved with no victims?")
            last_fp = fp
        raise RuntimeError(f"drain(): round budget exhausted after "
                           f"{max_rounds} rounds")

    # -- results ---------------------------------------------------------
    def result(self, req_id: int) -> FrontendRequest:
        """The request's front-end record (tokens, flags, timings)."""
        return self._reqs[req_id]

    def records(self) -> List[dict]:
        """Per-request timing records in the shape
        :func:`repro_torch.serving.loadgen.slo_report` scores: arrival/finish
        times, TTFT, mean per-token latency, token count."""
        out = []
        for fr in self._reqs.values():
            if fr.cancelled:
                continue
            ttft = (None if fr.first_token_t is None
                    else fr.first_token_t - fr.arrival_t)
            tpot = None
            if fr.finished_t is not None and fr.first_token_t is not None \
                    and len(fr.tokens) > 1:
                tpot = ((fr.finished_t - fr.first_token_t)
                        / (len(fr.tokens) - 1))
            out.append({"req_id": fr.req_id, "arrival_t": fr.arrival_t,
                        "finished_t": fr.finished_t, "ttft_s": ttft,
                        "tpot_s": tpot, "tokens": len(fr.tokens),
                        "oom": fr.oom})
        return out

    def report(self, *, slo_ttft_s: Optional[float] = None,
               slo_tpot_s: Optional[float] = None) -> Dict[str, object]:
        """The open-loop scorecard: :func:`slo_report` percentiles +
        goodput over this front end's finished requests, plus serving
        counters (rounds, overlap admissions, cancellations)."""
        rep = slo_report(self.records(), slo_ttft_s=slo_ttft_s,
                         slo_tpot_s=slo_tpot_s)
        rep["cancelled"] = sum(fr.cancelled for fr in self._reqs.values())
        rep["rounds"] = self.rounds
        rep["double_buffer"] = self.double_buffer
        rep["overlap_admitted"] = self.overlap_admitted
        return rep

    # -- the serving loop ------------------------------------------------
    def _progress(self) -> tuple:
        return (self.emitted_total, self.admitted_total, self.settled_total)

    def _has_work(self) -> bool:
        eng = self.engine
        return bool(self._arrivals or self._cancel_q
                    or eng.scheduler.has_waiting or eng.active)

    def _round(self) -> bool:
        """One scheduling round: apply deferred cancels, admit due
        arrivals, run one (possibly overlapped) engine tick — or, when
        the engine is idle, jump/sleep to the next arrival.  Returns
        False only when there is nothing left to do at all."""
        self._apply_cancels()
        self._pump_arrivals()
        eng = self.engine
        if not (eng.scheduler.has_waiting or eng.active):
            if not self._arrivals:
                return False
            wait = self._arrivals[0][0] - self.clock()
            if wait > 0:
                self.sleep(wait)
            self._pump_arrivals()
            if not (eng.scheduler.has_waiting or eng.active):
                return True     # the due arrivals were all cancelled
        self.rounds += 1
        pend = eng.step_begin()
        if self.double_buffer:
            # tick N is on the device; do tick N+1's host admission now
            self.overlap_admitted += self._pump_arrivals()
        emitted = eng.step_end(pend)
        if not self.double_buffer:
            self._pump_arrivals()
        if self.virtual_tick_s:
            self.clock.advance(self.virtual_tick_s)
        self._route(emitted)
        self._harvest_finished()
        return True

    def _pump_arrivals(self) -> int:
        """Move every due arrival into the engine's scheduler queue."""
        n = 0
        now = self.clock()
        while self._arrivals and self._arrivals[0][0] <= now:
            _, fid = heapq.heappop(self._arrivals)
            fr = self._reqs[fid]
            if fr.cancelled:
                self.settled_total += 1
                continue
            fr.engine_id = self.engine.submit(fr.prompt,
                                              fr.max_new_tokens)
            self._by_engine[fr.engine_id] = fr
            n += 1
        self.admitted_total += n
        return n

    def _apply_cancels(self) -> None:
        """Engine-side cancels deferred past an in-flight tick."""
        if not self._cancel_q:
            return
        assert self.engine._pending is None
        while self._cancel_q:
            fr = self._cancel_q.pop()
            self.settled_total += 1
            if fr.done:
                continue
            took = self.engine.cancel(fr.engine_id)
            if not took and fr.engine_id not in self.engine.finished:
                # stale handle: the engine no longer knows this id (the
                # request finished and was cleared, or was drained off a
                # retired router replica) — settle the front-end record
                # instead of leaving the stream to spin forever
                fr.done = True
        self._harvest_finished()

    def _route(self, emitted: Dict[int, object]) -> None:
        """Mirror this tick's emitted tokens into front-end streams."""
        now = self.clock()
        for eid, v in emitted.items():
            fr = self._by_engine.get(eid)
            if fr is None:
                continue
            toks = list(v) if isinstance(v, list) else [v]
            if fr.first_token_t is None and toks:
                fr.first_token_t = now
            fr.tokens.extend(toks)
            self.emitted_total += len(toks)

    def _harvest_finished(self) -> None:
        """Fold engine-finished requests into front-end records and drop
        them from the engine (the front end owns result retention)."""
        eng = self.engine
        if not eng.finished:
            return
        now = self.clock()
        for eid, req in eng.finished.items():
            fr = self._by_engine.pop(eid, None)
            if fr is None:
                continue    # submitted directly on the engine, not ours
            if fr.tokens != req.generated:
                raise AssertionError(
                    f"req {fr.req_id}: streamed tokens diverge from the "
                    f"engine's record ({len(fr.tokens)} streamed vs "
                    f"{len(req.generated)} generated)")
            fr.done = True
            fr.finished_t = now
            fr.oom = req.oom
            fr.cancelled = fr.cancelled or req.cancelled
            if not fr.cancelled:
                self._fresh[fr.req_id] = fr.tokens
        eng.clear_finished()
