"""The port's open-loop load generator (``repro_torch.serving.loadgen``) on the
CPU, ported from ``tests/test_loadgen.py`` and held to the JAX package's
copy: for one seed the two packages build bit-equal workloads (arrival
times, prompts, budgets, labels) for every mix and arrival process, and
``slo_report`` gives equal scorecards.

Pure numpy: no engine, no model.
"""
import json

import numpy as np
import pytest

from repro.serving import loadgen as jax_loadgen
from repro_torch.serving.loadgen import (MIXES, bursty_arrivals,
                                         build_workload, load_arrival_trace,
                                         poisson_arrivals, slo_report)


def test_seeded_reproducibility():
    a = build_workload(mix="chat", arrivals="poisson", n=32, seed=7,
                       vocab=500, rate=40.0)
    b = build_workload(mix="chat", arrivals="poisson", n=32, seed=7,
                       vocab=500, rate=40.0)
    assert [r.t for r in a] == [r.t for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert [r.max_new_tokens for r in a] == [r.max_new_tokens for r in b]
    c = build_workload(mix="chat", arrivals="poisson", n=32, seed=8,
                       vocab=500, rate=40.0)
    assert [r.t for r in a] != [r.t for r in c]
    d1 = build_workload(mix="agents", arrivals="bursty", n=32, seed=3)
    d2 = build_workload(mix="agents", arrivals="bursty", n=32, seed=3)
    assert [r.t for r in d1] == [r.t for r in d2]
    assert all(np.array_equal(x.prompt, y.prompt)
               for x, y in zip(d1, d2))


def test_workloads_sorted_and_labelled():
    for mix in MIXES:
        wl = build_workload(mix=mix, arrivals="poisson", n=16, seed=0,
                            rate=100.0)
        ts = [r.t for r in wl]
        assert ts == sorted(ts) and ts[0] >= 0
        assert all(r.mix == mix for r in wl)
    fast = build_workload(mix="chat", n=8, seed=0, time_scale=0.5)
    slow = build_workload(mix="chat", n=8, seed=0, time_scale=1.0)
    assert all(np.array_equal(f.prompt, s.prompt)
               for f, s in zip(fast, slow))
    assert all(abs(f.t - 0.5 * s.t) < 1e-12 for f, s in zip(fast, slow))


def test_poisson_interarrival_stats():
    """Mean gap = 1/rate and CV = 1, each within ~5 standard errors."""
    rate, n = 20.0, 4000
    times = poisson_arrivals(rate, n, np.random.default_rng(0))
    gaps = np.diff(np.concatenate([[0.0], times]))
    mean = gaps.mean()
    assert abs(mean - 1 / rate) < 5 * (1 / rate) / np.sqrt(n)
    cv = gaps.std() / mean
    assert abs(cv - 1.0) < 0.1
    with pytest.raises(ValueError):
        poisson_arrivals(0.0, 4, np.random.default_rng(0))


def test_bursty_dwell_sanity():
    """The MMPP spends time in each state per its dwell parameters and
    emits per its per-state rates; the result is burstier than Poisson."""
    kw = dict(rate_lo=10.0, rate_hi=200.0, dwell_lo_s=1.0,
              dwell_hi_s=0.2)
    times, states = bursty_arrivals(5000, np.random.default_rng(1), **kw)
    assert np.all(np.diff(times) >= 0)
    hi_frac = states.mean()
    assert 0.7 < hi_frac < 0.9
    runs = {0: [], 1: []}
    start = 0
    for i in range(1, len(states)):
        if states[i] != states[start]:
            runs[int(states[start])].append(times[i - 1] - times[start])
            start = i
    for s, dwell in ((0, kw["dwell_lo_s"]), (1, kw["dwell_hi_s"])):
        mean_run = np.mean(runs[s])
        assert 0.3 * dwell < mean_run < 2.0 * dwell, (s, mean_run)
    gaps = np.diff(times)
    assert gaps.std() / gaps.mean() > 1.2


def test_trace_arrivals_roundtrip(tmp_path):
    p = tmp_path / "arrivals.trace"
    p.write_text("0.0\n0.25\n"
                 + json.dumps({"t": 0.5, "prompt_len": 3,
                               "max_new_tokens": 7}) + "\n"
                 + "1.5\n")
    times, overrides = load_arrival_trace(p)
    assert list(times) == [0.0, 0.25, 0.5, 1.5]
    assert overrides[2] == {"prompt_len": 3, "max_new_tokens": 7}
    wl = build_workload(mix="classify", arrivals="trace", n=0, seed=0,
                        trace=p)
    assert len(wl) == 4 and [r.t for r in wl] == [0.0, 0.25, 0.5, 1.5]
    assert wl[2].prompt.size == 3 and wl[2].max_new_tokens == 7
    wl2 = build_workload(mix="classify", arrivals="trace", seed=0,
                         trace=[0.0, 0.1, 0.2])
    assert len(wl2) == 3
    bad = tmp_path / "bad.trace"
    bad.write_text("1.0\n0.5\n")
    with pytest.raises(ValueError):
        load_arrival_trace(bad)
    with pytest.raises(ValueError):
        build_workload(arrivals="trace")
    with pytest.raises(ValueError):
        build_workload(arrivals="uniform")


def test_mix_shapes():
    for name, m in MIXES.items():
        wl = build_workload(mix=name, n=64, seed=2, vocab=300, rate=50.0)
        for r in wl:
            body = r.prompt.size - m.shared_prefix
            assert m.prompt[0] <= body <= m.prompt[1], name
            assert m.gen[0] <= r.max_new_tokens <= m.gen[1], name
    ag = build_workload(mix="agents", n=8, seed=2, vocab=300)
    head = ag[0].prompt[:MIXES["agents"].shared_prefix]
    assert all(np.array_equal(r.prompt[:head.size], head) for r in ag)
    ch = build_workload(mix="chat", n=4, seed=2, vocab=300)
    per = MIXES["chat"].period
    for r in ch:
        p = r.prompt
        assert all(np.array_equal(p[i:i + per], p[:per])
                   for i in range(per, p.size - per, per))


SLO_RECORDS = [
    {"arrival_t": 0.0, "finished_t": 0.2, "ttft_s": 0.1,
     "tpot_s": 0.01, "tokens": 2},
    {"arrival_t": 0.0, "finished_t": 1.0, "ttft_s": 0.9,
     "tpot_s": 0.01, "tokens": 10},
    {"arrival_t": 0.5, "finished_t": None, "ttft_s": None,
     "tpot_s": None, "tokens": 0},
]


def test_slo_report_scoring():
    rep = slo_report(SLO_RECORDS, slo_ttft_s=0.5, slo_tpot_s=0.05)
    assert rep["requests"] == 3 and rep["finished"] == 2
    assert rep["slo_frac"] == 0.5
    assert abs(rep["throughput_tok_s"] - 12.0) < 1e-9
    assert abs(rep["goodput_tok_s"] - 2.0) < 1e-9
    assert rep["p99_ttft_s"] == pytest.approx(0.892)
    rep2 = slo_report(SLO_RECORDS)
    assert rep2["slo_frac"] == 1.0
    assert rep2["goodput_tok_s"] == rep2["throughput_tok_s"]
    assert slo_report([])["p50_ttft_s"] is None


# ---------------------------------------------------------------------------
# held to the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("arrivals", ["poisson", "bursty", "trace"])
def test_workloads_bit_equal_to_jax(mix, arrivals, tmp_path):
    """One seed, one workload: arrival times, prompts (dtype included),
    budgets and labels equal the JAX package's bit for bit."""
    kw = dict(mix=mix, arrivals=arrivals, n=24, seed=5, vocab=977,
              rate=33.0, time_scale=0.75)
    if arrivals == "bursty":
        kw["burst"] = dict(rate_lo=8.0, rate_hi=120.0, dwell_lo_s=0.4,
                           dwell_hi_s=0.1)
    if arrivals == "trace":
        p = tmp_path / "arrivals.trace"
        p.write_text("0.0\n0.125\n" + json.dumps(
            {"t": 0.3, "prompt_len": 5, "max_new_tokens": 2}) + "\n0.9\n")
        kw["trace"] = p
    ours = build_workload(**kw)
    theirs = jax_loadgen.build_workload(**kw)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a.t == b.t and a.max_new_tokens == b.max_new_tokens
        assert a.mix == b.mix
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        assert np.array_equal(a.prompt, b.prompt)


def test_arrival_processes_bit_equal_to_jax():
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    assert np.array_equal(poisson_arrivals(17.0, 300, rng_a),
                          jax_loadgen.poisson_arrivals(17.0, 300, rng_b))
    ta, sa = bursty_arrivals(300, rng_a, rate_lo=3.0, dwell_hi_s=0.5)
    tb, sb = jax_loadgen.bursty_arrivals(300, rng_b, rate_lo=3.0,
                                         dwell_hi_s=0.5)
    assert np.array_equal(ta, tb) and np.array_equal(sa, sb)


@pytest.mark.parametrize("slo", [dict(), dict(slo_ttft_s=0.5),
                                 dict(slo_ttft_s=0.5, slo_tpot_s=0.005)],
                         ids=["none", "ttft", "ttft+tpot"])
def test_slo_report_equals_jax(slo):
    rng = np.random.default_rng(3)
    recs = []
    for i in range(40):
        arrival = float(rng.uniform(0, 2))
        done = rng.uniform() < 0.9
        ttft = float(rng.uniform(0.01, 1.0))
        n = int(rng.integers(1, 30))
        recs.append({"arrival_t": arrival,
                     "finished_t": arrival + ttft + 0.01 * n if done
                     else None,
                     "ttft_s": ttft if done else None,
                     "tpot_s": float(rng.uniform(0.001, 0.01))
                     if done and n > 1 else None,
                     "tokens": n})
    assert slo_report(recs, **slo) == jax_loadgen.slo_report(recs, **slo)
    assert slo_report([], **slo) == jax_loadgen.slo_report([], **slo)
