"""Seeded open-loop load generation for the serving front end: a copy of
``repro/serving/loadgen.py`` (numpy only), so that the same seed gives the
same workload, bit for bit, in both packages.

Closed-loop evaluation (pre-stage everything, ``run_to_completion``)
hides queueing: the engine is never asked to absorb a burst, so TTFT
degenerates to prefill time.  An *open-loop* generator emits requests on
its own clock regardless of engine progress — the standard way to expose
tail latency under load.  This module builds such workloads as plain
data (``TimedRequest`` lists): arrival processes on one axis, request
*shape* mixes on the other, everything drawn from one
``numpy.random.default_rng(seed)`` so a seed pins the full workload —
arrival times AND token content — bit for bit.

Arrival processes:

  * ``poisson``  — iid exponential inter-arrivals at ``rate`` req/s (the
    memoryless baseline; inter-arrival CV = 1).
  * ``bursty``   — a two-state Markov-modulated Poisson process (MMPP):
    the generator dwells in a *calm* state (``rate_lo``, mean dwell
    ``dwell_lo_s``) and a *burst* state (``rate_hi``, ``dwell_hi_s``),
    switching after exponential dwell times.  Inter-arrival CV > 1 —
    the burst state is what fills the waiting queue and triggers
    preemption.
  * ``trace``    — replay recorded arrival times from a file (one float
    per line, or JSONL records with ``t`` and optional per-request
    ``prompt_len`` / ``max_new_tokens`` overrides).

Workload mixes (named request-shape distributions, chosen to exercise
specific engine paths):

  * ``chat``     — mid-length prompts with periodic structure, mid-length
    generations: the n-gram drafter locks onto the repetition, so this
    mix exercises speculative decoding (DESIGN.md §11).
  * ``longdoc``  — long prompts, short summaries: chunked-prefill
    streaming under the token budget.
  * ``agents``   — a shared system prompt (sampled once per workload)
    with short per-request tails: the prefix cache (DESIGN.md §9) serves
    the shared pages after the first request computes them.
  * ``classify`` — tiny prompts, 1-2 token answers: admission/slot-churn
    throughput.

The SLO helper (:func:`slo_report`) turns per-request timings into the
serving scorecard — p50/p99 TTFT, per-token latency, and
goodput-under-SLO (tokens/s counting only requests that met their
latency targets).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class WorkloadMix:
    """A named request-shape distribution.

    ``prompt`` / ``gen`` are inclusive ``(lo, hi)`` length ranges.
    ``shared_prefix`` > 0 prepends a per-workload system prompt of that
    many tokens (sampled once per seed) to every request.  ``period``
    > 0 builds the prompt body by tiling a short random pattern, giving
    greedy decoding a cycle the n-gram drafter can exploit.
    """
    name: str
    prompt: Tuple[int, int]
    gen: Tuple[int, int]
    shared_prefix: int = 0
    period: int = 0


MIXES: Dict[str, WorkloadMix] = {m.name: m for m in (
    WorkloadMix("chat", prompt=(12, 24), gen=(8, 24), period=4),
    WorkloadMix("longdoc", prompt=(48, 96), gen=(4, 10)),
    WorkloadMix("agents", prompt=(2, 8), gen=(6, 16), shared_prefix=32),
    WorkloadMix("classify", prompt=(4, 12), gen=(1, 2)),
)}

ARRIVALS = ("poisson", "bursty", "trace")


@dataclass
class TimedRequest:
    """One open-loop request: arrive at offset ``t`` (seconds from the
    workload epoch) with this prompt, generate ``max_new_tokens``."""
    t: float
    prompt: np.ndarray           # (S0,) int32
    max_new_tokens: int
    mix: str = ""


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------
def poisson_arrivals(rate: float, n: int,
                     rng: np.random.Generator) -> np.ndarray:
    """``n`` arrival offsets with iid Exp(1/rate) gaps (Poisson process)."""
    if rate <= 0:
        raise ValueError("rate must be > 0 req/s")
    return np.cumsum(rng.exponential(1.0 / rate, n))


def bursty_arrivals(n: int, rng: np.random.Generator, *,
                    rate_lo: float = 5.0, rate_hi: float = 50.0,
                    dwell_lo_s: float = 1.0, dwell_hi_s: float = 0.25
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Two-state MMPP: ``(times, states)`` with ``states[i]`` the
    modulating state (0 = calm, 1 = burst) that emitted arrival ``i``.

    Exact simulation via memorylessness: each candidate gap is drawn at
    the current state's rate; a gap that would cross the state's dwell
    boundary is discarded, the clock jumps to the boundary, and the
    state flips with a fresh dwell draw.
    """
    if min(rate_lo, rate_hi) <= 0 or min(dwell_lo_s, dwell_hi_s) <= 0:
        raise ValueError("rates and dwell times must be > 0")
    times = np.empty(n)
    states = np.empty(n, np.int64)
    rates, dwells = (rate_lo, rate_hi), (dwell_lo_s, dwell_hi_s)
    t, s = 0.0, 0
    edge = rng.exponential(dwells[0])
    i = 0
    while i < n:
        gap = rng.exponential(1.0 / rates[s])
        if t + gap >= edge:
            t = edge
            s ^= 1
            edge = t + rng.exponential(dwells[s])
            continue
        t += gap
        times[i] = t
        states[i] = s
        i += 1
    return times, states


def load_arrival_trace(path) -> Tuple[np.ndarray, List[dict]]:
    """Parse a trace file into ``(times, overrides)``.

    Each non-empty line is either a bare float (an arrival offset in
    seconds) or a JSON object with ``t`` plus optional ``prompt_len`` /
    ``max_new_tokens`` per-request shape overrides.  Times must be
    non-negative and non-decreasing.
    """
    times: List[float] = []
    overrides: List[dict] = []
    for ln, line in enumerate(Path(path).read_text().splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("{"):
            rec = json.loads(line)
            times.append(float(rec["t"]))
            overrides.append({k: int(rec[k])
                              for k in ("prompt_len", "max_new_tokens")
                              if k in rec})
        else:
            times.append(float(line))
            overrides.append({})
    arr = np.asarray(times, float)
    if arr.size and (arr[0] < 0 or np.any(np.diff(arr) < 0)):
        raise ValueError(f"{path}: arrival times must be non-negative "
                         f"and sorted")
    return arr, overrides


# ---------------------------------------------------------------------------
# workload synthesis
# ---------------------------------------------------------------------------
def _sample_prompt(mix: WorkloadMix, rng: np.random.Generator, vocab: int,
                   shared: Optional[np.ndarray],
                   prompt_len: Optional[int] = None) -> np.ndarray:
    lo, hi = mix.prompt
    n = int(prompt_len if prompt_len is not None
            else rng.integers(lo, hi + 1))
    if mix.period:
        pat = rng.integers(0, vocab, mix.period)
        body = np.tile(pat, -(-n // mix.period))[:n]
    else:
        body = rng.integers(0, vocab, n)
    if shared is not None:
        body = np.concatenate([shared, body])
    return body.astype(np.int32)


def build_workload(mix: str = "chat", arrivals: str = "poisson",
                   n: int = 64, *, seed: int = 0, vocab: int = 1000,
                   rate: float = 50.0, burst: Optional[dict] = None,
                   trace=None, time_scale: float = 1.0
                   ) -> List[TimedRequest]:
    """Build a seeded open-loop workload (sorted by arrival time).

    mix: a name from :data:`MIXES` or a :class:`WorkloadMix`.
    arrivals: ``"poisson"`` (uses ``rate``), ``"bursty"`` (kwargs via
        ``burst=``), or ``"trace"`` (``trace=`` a file path or a
        sequence of arrival offsets; file records may override request
        shapes, and ``n`` is then taken from the trace).
    time_scale: multiply all arrival offsets (compress or stretch a
        workload without changing its content — the same requests
        arrive faster or slower).
    """
    rng = np.random.default_rng(seed)
    m = MIXES[mix] if isinstance(mix, str) else mix
    overrides: List[dict] = []
    if arrivals == "poisson":
        times = poisson_arrivals(rate, n, rng)
    elif arrivals == "bursty":
        times, _ = bursty_arrivals(n, rng, **(burst or {}))
    elif arrivals == "trace":
        if trace is None:
            raise ValueError("arrivals='trace' needs trace=path-or-times")
        if isinstance(trace, (str, Path)):
            times, overrides = load_arrival_trace(trace)
        else:
            times = np.asarray(trace, float)
            if times.size and (times[0] < 0 or np.any(np.diff(times) < 0)):
                raise ValueError("trace times must be non-negative and "
                                 "sorted")
        n = len(times)
    else:
        raise ValueError(f"arrivals must be one of {ARRIVALS}, "
                         f"got {arrivals!r}")
    shared = (rng.integers(0, vocab, m.shared_prefix).astype(np.int32)
              if m.shared_prefix else None)
    out: List[TimedRequest] = []
    for i in range(n):
        ov = overrides[i] if overrides else {}
        prompt = _sample_prompt(m, rng, vocab, shared,
                                prompt_len=ov.get("prompt_len"))
        gen = int(ov.get("max_new_tokens",
                         rng.integers(m.gen[0], m.gen[1] + 1)))
        out.append(TimedRequest(float(times[i]) * time_scale, prompt,
                                gen, m.name))
    return out


# ---------------------------------------------------------------------------
# SLO scorecard
# ---------------------------------------------------------------------------
def percentile(values: Sequence[float], p: float) -> Optional[float]:
    """Exact percentile by linear interpolation (None on empty input)."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, float), p))


def slo_report(records: Sequence[dict], *,
               slo_ttft_s: Optional[float] = None,
               slo_tpot_s: Optional[float] = None) -> Dict[str, object]:
    """Score finished open-loop requests against latency SLOs.

    records: dicts with ``ttft_s`` (arrival to first token), ``tpot_s``
        (mean time per output token after the first; None for 1-token
        requests), and ``tokens`` (generated count) — the shape
        ``ServingFrontend.records()`` emits.

    Returns p50/p90/p99 TTFT, p50/p99 per-token latency, total
    throughput, and *goodput-under-SLO*: tokens/s counting only requests
    whose TTFT and per-token latency both met their targets (a missing
    target always passes).  Throughput/goodput use the workload
    makespan (first arrival to last finish).
    """
    done = [r for r in records if r.get("finished_t") is not None]
    ttft = [r["ttft_s"] for r in done if r.get("ttft_s") is not None]
    tpot = [r["tpot_s"] for r in done if r.get("tpot_s") is not None]
    out: Dict[str, object] = {
        "requests": len(records), "finished": len(done),
        "p50_ttft_s": percentile(ttft, 50),
        "p90_ttft_s": percentile(ttft, 90),
        "p99_ttft_s": percentile(ttft, 99),
        "p50_tpot_s": percentile(tpot, 50),
        "p99_tpot_s": percentile(tpot, 99),
        "slo_ttft_s": slo_ttft_s, "slo_tpot_s": slo_tpot_s,
        "throughput_tok_s": None, "goodput_tok_s": None,
        "slo_frac": None,
    }
    if not done:
        return out
    span = (max(r["finished_t"] for r in done)
            - min(r["arrival_t"] for r in done))
    total = sum(r["tokens"] for r in done)

    def meets(r) -> bool:
        if slo_ttft_s is not None and (r.get("ttft_s") is None
                                       or r["ttft_s"] > slo_ttft_s):
            return False
        if slo_tpot_s is not None and r.get("tpot_s") is not None \
                and r["tpot_s"] > slo_tpot_s:
            return False
        return True

    good = [r for r in done if meets(r)]
    out["slo_frac"] = len(good) / len(done)
    if span > 0:
        out["throughput_tok_s"] = total / span
        out["goodput_tok_s"] = sum(r["tokens"] for r in good) / span
    return out
