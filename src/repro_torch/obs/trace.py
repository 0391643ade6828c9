"""Per-tick serving trace: bounded ring buffers + JSONL / Chrome exporters.

:class:`ServingTelemetry` is the one observability object the serving
stack shares (DESIGN.md §10): the engine records one structured
:data:`tick` event per ``step()`` (dispatch kind, packed vs padded
tokens, prefill/decode split, pool state, preemptions, host vs device
time), the scheduler records request lifecycle :data:`span` events
(submit -> admit -> first_token -> finish/preempt/cancel), and both feed
the
shared :class:`~repro_torch.obs.metrics.MetricsRegistry` (TTFT / latency /
inter-token / queue-wait / tick-wall histograms, token counters).

Everything is host-side and allocation-cheap: events are plain dicts in
``collections.deque`` rings (oldest dropped at capacity — ``dropped``
counts what fell off, so exporters can say so), and a disabled instance
(``enabled=False``) costs one attribute check per hook.

Exporters:

  * ``dump(path)`` — JSONL (one record per line: a ``meta`` header with
    the registry snapshot and optional engine metrics, then ticks and
    spans in time order), or Chrome ``trace_event`` JSON when the path
    ends in ``.json`` — load that one in ``chrome://tracing`` or
    `Perfetto <https://ui.perfetto.dev>`_: engine ticks and the device
    window on two timeline rows, every request on its own row with
    queued/running phases and a first-token instant marker.

``tools/tracestats.py`` summarizes (and ``--check`` validates) either
format from the command line.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry

# v2: per-tick speculative-decoding fields `drafted`/`accepted`
# (DESIGN.md §11) joined the tick schema
# v3: the `cancel` span kind (open-loop front end, DESIGN.md §12) — a
# second terminal event alongside `finish`
# v4: KV capacity tiers (DESIGN.md §13) — per-tick `swap_in`/`swap_out`
# host-tier page counts and the `quant` pool flag, the `swap_out`/
# `swap_in` span kinds around preempt/resume, and the `vacate` span kind
# (admission-dry slot giveback: pages returned without a policy
# eviction, so admit counts stay balanced for the span-pairing check)
SCHEMA_VERSION = 4

# request lifecycle span kinds, in legal order of first appearance;
# `finish` and `cancel` are the terminal kinds (at most one per request).
# `preempt` is a policy eviction; `vacate` is an admission-dry giveback
# (prefill could not get pages, nothing was evicted) — both requeue the
# request, so every later re-admission pairs with exactly one of them.
# `swap_out` rides with a preempt (pages parked on host), `swap_in` with
# the re-admission that streams them back (DESIGN.md §13).
SPAN_KINDS = ("submit", "admit", "first_token", "preempt", "vacate",
              "swap_out", "swap_in", "finish", "cancel")

# fields every tick record carries (the exporter/validator contract —
# tools/tracestats.py --check and tests/test_obs.py enforce it)
TICK_FIELDS = ("tick", "t", "kind", "wall_s", "host_s", "device_s",
               "packed_tokens", "padded_tokens", "prefill_tokens",
               "decode_tokens", "drafted", "accepted", "emitted",
               "live_slots", "waiting",
               "pool_free", "pool_cached", "pool_in_use",
               "prefix_hit_tokens", "preemptions", "cow_copies",
               "dispatches", "finished", "swap_in", "swap_out", "quant")


class Ring:
    """Bounded append-only buffer: keeps the newest ``capacity`` items
    and counts how many older ones were dropped."""

    __slots__ = ("_q", "capacity", "total")

    def __init__(self, capacity: int):
        assert capacity >= 1
        self.capacity = capacity
        self._q: deque = deque(maxlen=capacity)
        self.total = 0

    def append(self, item) -> None:
        self._q.append(item)
        self.total += 1

    @property
    def dropped(self) -> int:
        return self.total - len(self._q)

    def __len__(self) -> int:
        return len(self._q)

    def items(self) -> list:
        """Oldest-to-newest snapshot of what the ring still holds."""
        return list(self._q)


def _jsonable(o):
    """json.dump default= hook: numpy scalars/arrays -> python."""
    import numpy as np
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


class ServingTelemetry:
    """Shared telemetry spine for one serving engine (or scheduler).

    Args:
        enabled: ``False`` turns every hook into a cheap no-op (no clock
            reads, no ring appends) — the engine's ``telemetry=False``
            escape hatch for overhead-sensitive benchmarking.
        capacity: tick-ring size; the span ring holds ``8 * capacity``
            (a tick touches at most a few lifecycle events per slot).
        clock: timestamp source (tests inject fake clocks).  All stored
            times are relative to the first recorded event (``epoch``).
    """

    def __init__(self, *, enabled: bool = True, capacity: int = 4096,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = enabled
        self.clock = clock
        self.epoch: Optional[float] = None
        self.registry = MetricsRegistry()
        self.ticks = Ring(capacity)
        self.spans = Ring(8 * capacity)
        r = self.registry
        # scheduler-fed latency histograms (seconds)
        self.ttft_s = r.histogram("ttft_s")
        self.latency_s = r.histogram("latency_s")
        self.inter_token_s = r.histogram("inter_token_s")
        self.queue_wait_s = r.histogram("queue_wait_s")
        # engine-fed per-tick histograms / counters
        self.tick_wall_s = r.histogram("tick_wall_s")
        self._c_ticks = r.counter("ticks")
        self._c_packed = r.counter("packed_tokens")
        self._c_padded = r.counter("padded_tokens")
        self._c_prefill = r.counter("prefill_tokens")
        self._c_decode = r.counter("decode_tokens")
        self._c_host = r.counter("host_s")
        self._c_device = r.counter("device_s")
        # speculative decoding (DESIGN.md §11): proposal/accept totals
        # plus the per-verify accept-length distribution (integer-valued,
        # so bucket edges sit at half-integers up to draft_k's practical
        # ceiling)
        self._c_drafted = r.counter("spec.drafted")
        self._c_accepted = r.counter("spec.accepted")
        self.spec_accept_len = r.histogram(
            "spec_accept_len", edges=[i + 0.5 for i in range(33)])
        # KV capacity tiers (DESIGN.md §13): host<->device page traffic
        self._c_swap_in = r.counter("swap.in_pages")
        self._c_swap_out = r.counter("swap.out_pages")

    def _t(self, t: Optional[float] = None) -> float:
        """Normalize an absolute clock value to the trace epoch (the
        first event ever recorded pins it)."""
        if t is None:
            t = self.clock()
        if self.epoch is None:
            self.epoch = t
        return t - self.epoch

    # -- recording hooks ------------------------------------------------
    def span(self, req_id: int, kind: str, t: Optional[float] = None,
             **extra) -> None:
        """One request lifecycle event.  ``t`` is an absolute clock value
        the caller already read (or None to read now); extra fields ride
        along into the trace record."""
        if not self.enabled:
            return
        assert kind in SPAN_KINDS, kind
        ev = {"type": "span", "req": int(req_id), "kind": kind,
              "t": self._t(t)}
        if extra:
            ev.update(extra)
        self.spans.append(ev)

    def record_tick(self, *, t: float, kind: str, wall_s: float,
                    device_s: float, device_t: Optional[float],
                    packed_tokens: int, padded_tokens: int,
                    prefill_tokens: int, decode_tokens: int,
                    emitted: int, live_slots: int, waiting: int,
                    pool_free: int, pool_cached: int, pool_in_use: int,
                    prefix_hit_tokens: int, preemptions: int,
                    cow_copies: int, dispatches: int,
                    finished: int, drafted: int = 0,
                    accepted: int = 0, swap_in: int = 0,
                    swap_out: int = 0, quant: bool = False) -> None:
        """One engine tick.  ``t``/``device_t`` are absolute clock values
        (normalized here); everything else is this tick's delta or
        point-in-time state."""
        if not self.enabled:
            return
        host_s = max(0.0, wall_s - device_s)
        ev = {"type": "tick", "tick": self.ticks.total, "t": self._t(t),
              "kind": kind, "wall_s": wall_s, "host_s": host_s,
              "device_s": device_s,
              "device_t": None if device_t is None else self._t(device_t),
              "packed_tokens": packed_tokens,
              "padded_tokens": padded_tokens,
              "prefill_tokens": prefill_tokens,
              "decode_tokens": decode_tokens,
              "drafted": drafted, "accepted": accepted,
              "emitted": emitted,
              "live_slots": live_slots, "waiting": waiting,
              "pool_free": pool_free, "pool_cached": pool_cached,
              "pool_in_use": pool_in_use,
              "prefix_hit_tokens": prefix_hit_tokens,
              "preemptions": preemptions, "cow_copies": cow_copies,
              "dispatches": dispatches, "finished": finished,
              "swap_in": swap_in, "swap_out": swap_out,
              "quant": bool(quant)}
        self.ticks.append(ev)
        self.tick_wall_s.record(wall_s)
        self._c_ticks.inc()
        self._c_packed.inc(packed_tokens)
        self._c_padded.inc(padded_tokens)
        self._c_prefill.inc(prefill_tokens)
        self._c_decode.inc(decode_tokens)
        self._c_host.inc(host_s)
        self._c_device.inc(device_s)
        self._c_drafted.inc(drafted)
        self._c_accepted.inc(accepted)
        self._c_swap_in.inc(swap_in)
        self._c_swap_out.inc(swap_out)

    # -- reporting ------------------------------------------------------
    def summary(self) -> Dict[str, object]:
        """Compact engine-metrics block: ring occupancy, token totals,
        budget utilization (packed / padded — the padding-waste view),
        host/device split, and tick-wall percentiles."""
        packed = self._c_packed.value
        padded = self._c_padded.value
        return {
            "enabled": self.enabled,
            "ticks": len(self.ticks), "dropped_ticks": self.ticks.dropped,
            "spans": len(self.spans), "dropped_spans": self.spans.dropped,
            "packed_tokens": packed, "padded_tokens": padded,
            "prefill_tokens": self._c_prefill.value,
            "decode_tokens": self._c_decode.value,
            "drafted_tokens": self._c_drafted.value,
            "accepted_tokens": self._c_accepted.value,
            "budget_utilization": packed / padded if padded else 0.0,
            "swap_in_pages": self._c_swap_in.value,
            "swap_out_pages": self._c_swap_out.value,
            "host_s": self._c_host.value, "device_s": self._c_device.value,
            "p50_tick_wall_s": self.tick_wall_s.percentile(50),
            "p99_tick_wall_s": self.tick_wall_s.percentile(99),
        }

    # -- exporters ------------------------------------------------------
    def _meta(self, extra: Optional[dict]) -> dict:
        meta = {"type": "meta", "schema": SCHEMA_VERSION,
                "dropped_ticks": self.ticks.dropped,
                "dropped_spans": self.spans.dropped,
                "metrics": self.registry.snapshot()}
        if extra is not None:
            meta["engine"] = extra
        return meta

    def dump(self, path, fmt: Optional[str] = None,
             meta: Optional[dict] = None) -> str:
        """Write the trace to ``path``.  ``fmt``: ``"jsonl"`` or
        ``"chrome"``; None picks by suffix (``.json`` -> Chrome
        trace_event, anything else -> JSONL).  ``meta`` (e.g.
        ``engine.metrics()``) is embedded so offline tools can
        cross-check trace sums against engine totals.  Returns the
        format written."""
        path = str(path)
        if fmt is None:
            fmt = "chrome" if path.endswith(".json") else "jsonl"
        if fmt == "chrome":
            with open(path, "w") as f:
                json.dump({"traceEvents": self.chrome_events(),
                           "displayTimeUnit": "ms",
                           "metadata": self._meta(meta)},
                          f, default=_jsonable)
        elif fmt == "jsonl":
            records = sorted(self.ticks.items() + self.spans.items(),
                             key=lambda e: e["t"])
            with open(path, "w") as f:
                f.write(json.dumps(self._meta(meta),
                                   default=_jsonable) + "\n")
                for ev in records:
                    f.write(json.dumps(ev, default=_jsonable) + "\n")
        else:
            raise ValueError(f"unknown trace format {fmt!r} "
                             f"(expected 'jsonl' or 'chrome')")
        return fmt

    def chrome_events(self) -> List[dict]:
        """Chrome ``trace_event`` array (ts/dur in microseconds).

        Layout: pid 0 = the engine; tid 0 carries one complete ("X")
        event per tick, tid 1 the fenced device window of each tick, and
        tid ``100 + req_id`` one row per request with "queued" /
        "running" phase events (preemption closes a running phase and
        reopens queued) plus first-token / swap instant markers.  Ticks
        that moved pages across the host tier (DESIGN.md §13) also feed
        a "swap pages" counter track.
        """
        US = 1e6
        evs: List[dict] = [
            {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
             "args": {"name": "repro_torch.serving"}},
            {"ph": "M", "pid": 0, "tid": 0, "name": "thread_name",
             "args": {"name": "engine ticks"}},
            {"ph": "M", "pid": 0, "tid": 1, "name": "thread_name",
             "args": {"name": "device dispatch"}},
        ]
        last_t = 0.0
        for ev in self.ticks.items():
            last_t = max(last_t, ev["t"] + ev["wall_s"])
            args = {k: v for k, v in ev.items() if k not in ("type", "t")}
            evs.append({"ph": "X", "pid": 0, "tid": 0, "cat": "tick",
                        "name": f"tick[{ev['kind']}]",
                        "ts": ev["t"] * US, "dur": ev["wall_s"] * US,
                        "args": args})
            if ev["device_s"] > 0 and ev["device_t"] is not None:
                evs.append({"ph": "X", "pid": 0, "tid": 1, "cat": "device",
                            "name": "dispatch", "ts": ev["device_t"] * US,
                            "dur": ev["device_s"] * US,
                            "args": {"tick": ev["tick"]}})
            if ev.get("swap_in", 0) or ev.get("swap_out", 0):
                evs.append({"ph": "C", "pid": 0, "cat": "swap",
                            "name": "swap pages", "ts": ev["t"] * US,
                            "args": {"in": ev.get("swap_in", 0),
                                     "out": ev.get("swap_out", 0)}})
        per_req: Dict[int, list] = {}
        for s in self.spans.items():
            per_req.setdefault(s["req"], []).append(s)
            last_t = max(last_t, s["t"])
        for rid in sorted(per_req):
            tid = 100 + rid
            evs.append({"ph": "M", "pid": 0, "tid": tid,
                        "name": "thread_name",
                        "args": {"name": f"req {rid}"}})
            open_t: Optional[float] = None
            phase: Optional[str] = None

            def close(until: float, spans=evs, t_id=tid):
                if phase is not None and open_t is not None:
                    spans.append({"ph": "X", "pid": 0, "tid": t_id,
                                  "cat": "request", "name": phase,
                                  "ts": open_t * US,
                                  "dur": max(0.0, until - open_t) * US})

            for s in per_req[rid]:
                kind, t = s["kind"], s["t"]
                if kind == "submit":
                    close(t)
                    open_t, phase = t, "queued"
                elif kind == "admit":
                    close(t)
                    open_t, phase = t, "running"
                elif kind in ("preempt", "vacate"):
                    close(t)
                    open_t, phase = t, "queued"   # requeued at the front
                elif kind in ("finish", "cancel"):
                    close(t)
                    open_t = phase = None
                elif kind == "first_token":
                    evs.append({"ph": "i", "pid": 0, "tid": tid, "s": "t",
                                "cat": "request", "name": "first_token",
                                "ts": t * US})
                elif kind in ("swap_out", "swap_in"):
                    # host-tier traffic markers (DESIGN.md §13): pages
                    # parked on / restored from the host swap store
                    evs.append({"ph": "i", "pid": 0, "tid": tid, "s": "t",
                                "cat": "swap", "name": kind,
                                "ts": t * US,
                                "args": {"pages": s.get("pages", 0)}})
            close(last_t)  # still in flight at dump time: draw to the edge
        return evs
