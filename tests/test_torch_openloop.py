"""The port's open-loop front end (``repro_torch.serving.frontend``) on the
CPU, ported from ``tests/test_openloop.py`` and held to the JAX package.

What is pinned here:

  * open-loop serving is a *scheduling* change, never a *token* change:
    streams served through ``ServingFrontend`` on a virtual clock are
    byte-identical to closed-loop ``run_to_completion`` on the same
    workload, with dispatch double-buffering on or off, and one front-end
    run gives the JAX front end's streams and scorecard on the same
    (bridged) weights;
  * burst overload soaks (preemption + prefix cache + speculation, fp and
    int8-swap) finish exactly and leave the allocator/scheduler empty;
  * cancel releases pages from every lifecycle stage and is deferred
    while the victim's tokens are packed into an in-flight tick;
  * ``run_to_completion`` and ``drain`` raise instead of spinning when no
    step can make progress — and ``drain`` does not raise when the only
    work left is cancelled arrivals (the JAX front end's drain fault);
  * the ``step_begin``/``step_end`` pairing contract;
  * a port trace passes ``tools/tracestats.py --check`` (run as a
    subprocess);
  * two derandomised hypothesis state machines (submit / tick / cancel /
    stream / drain over the fp engine and over int8 pages with swap and
    the host tier) never double-free pages, never drop a finish event,
    and stream exactly the engine's tokens.  Not held to the JAX
    machines, which hit the drain fault.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduced as jax_reduced
from repro.models import model as JM
from repro.serving import PagedServingEngine as JaxPagedServingEngine
from repro.serving import ServingFrontend as JaxServingFrontend
from repro.serving import VirtualClock as JaxVirtualClock
from repro_torch.config import get_config, reduced
from repro_torch.serving import (PagedServingEngine, ServingFrontend,
                                 VirtualClock, loadgen)
from repro_torch.weights import params_from_numpy

try:
    from hypothesis import settings
    from hypothesis import strategies as st
    from hypothesis.stateful import (RuleBasedStateMachine, invariant,
                                     precondition, rule)
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

BRANCH_GAIN = 8.0        # see test_torch_paged_serving
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# derandomised and without an example database: every run draws the same
# examples and reads or writes nothing under .hypothesis/
FUZZ = dict(derandomize=True, database=None, deadline=None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _hypothesis_storage(tmp_path_factory):
    """Hypothesis caches the constants of the modules it scans under its
    storage directory even without an example database: point it at a
    temporary directory for this module, so that nothing lands in
    ``.hypothesis/``, and restore it after."""
    if not HAVE_HYPOTHESIS:
        yield
        return
    from hypothesis import configuration
    old = getattr(configuration, "__hypothesis_home_directory")
    configuration.set_hypothesis_home_dir(
        tmp_path_factory.mktemp("hypothesis"))
    yield
    configuration.set_hypothesis_home_dir(old)


def _bridged():
    """Reduced granite-3-2b, fp32, the JAX package's init through numpy:
    (JAX cfg, JAX params, port cfg, port params), the same weights."""
    jcfg = jax_reduced(jax_get_config("granite-3-2b"))
    cfg = reduced(get_config("granite-3-2b"))
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    for k in ("attn", "mlp"):
        tree["layers"][k]["wo"] = tree["layers"][k]["wo"] * BRANCH_GAIN
    return (jcfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_numpy(tree, cfg, device="cpu"))


@pytest.fixture(scope="module")
def bridged():
    return _bridged()


@pytest.fixture(scope="module")
def setup(bridged):
    return bridged[2], bridged[3]


ENGINE_KW = dict(max_slots=4, block_size=4, max_blocks_per_seq=16,
                 num_blocks=64, prefill_chunk=8)


def _open_engine(cfg, params, vc, **kw):
    return PagedServingEngine(cfg, params, clock=vc, device="cpu",
                              **dict(ENGINE_KW, **kw))


def _closed(cfg, params, wl):
    eng = PagedServingEngine(cfg, params, device="cpu", **ENGINE_KW)
    ids = [eng.submit(r.prompt, r.max_new_tokens) for r in wl]
    out = eng.run_to_completion()
    return [out[i] for i in ids]


# ---------------------------------------------------------------------------
# open-loop == closed-loop, and == the JAX front end
# ---------------------------------------------------------------------------
def test_open_vs_closed_byte_identical(setup):
    cfg, params = setup
    wl = loadgen.build_workload(mix="chat", arrivals="poisson", n=10,
                                seed=11, vocab=cfg.vocab, rate=200.0)
    closed = _closed(cfg, params, wl)
    assert len({t for s in closed for t in s}) > 3
    for double_buffer in (True, False):
        vc = VirtualClock()
        fe = ServingFrontend(_open_engine(cfg, params, vc),
                             double_buffer=double_buffer,
                             virtual_tick_s=0.002)
        fids = fe.submit_workload(wl)
        out = fe.drain()
        assert [out[f] for f in fids] == closed, double_buffer
        rep = fe.report()
        assert rep["finished"] == len(wl)
        assert rep["p99_ttft_s"] is not None
        assert rep["p50_tpot_s"] is not None
        assert rep["double_buffer"] is double_buffer


@pytest.mark.parametrize("double_buffer", [True, False])
def test_frontend_run_matches_jax(bridged, double_buffer):
    """One bursty open-loop run through the JAX front end and the port's,
    each on its own virtual clock: the same streams, the same records
    (TTFT and per-token latency on the virtual timeline) and the same
    scorecard, so the same ticks in the same order."""
    jcfg, jparams, cfg, params = bridged
    wl = loadgen.build_workload(mix="agents", arrivals="bursty", n=12,
                                seed=4, vocab=cfg.vocab)
    kw = dict(ENGINE_KW, num_blocks=24, token_budget=12, prefix_cache=True)
    runs = []
    for make, Clock, FE in (
            (lambda vc: JaxPagedServingEngine(jcfg, jparams, clock=vc, **kw),
             JaxVirtualClock, JaxServingFrontend),
            (lambda vc: PagedServingEngine(cfg, params, clock=vc,
                                           device="cpu", **kw),
             VirtualClock, ServingFrontend)):
        vc = Clock()
        fe = FE(make(vc), double_buffer=double_buffer,
                virtual_tick_s=0.003)
        fids = fe.submit_workload(wl)
        fe.cancel(fids[5])
        out = fe.drain()
        runs.append((out, fe.records(), fe.report(slo_ttft_s=0.02),
                     fe.engine.metrics()["prefix_cache"]))
    (jout, jrec, jrep, jpc), (out, rec, rep, pc) = runs
    assert out == jout and len(out) == len(wl) - 1
    assert rec == jrec
    assert rep == jrep
    assert pc == jpc and pc["hit_tokens"] > 0


def test_openloop_trace_arrivals(setup):
    """A trace workload (shape overrides included) serves to the same
    streams as the equivalent closed-loop run."""
    cfg, params = setup
    wl = loadgen.build_workload(mix="classify", arrivals="trace", seed=0,
                                vocab=cfg.vocab,
                                trace=[0.0, 0.0, 0.05, 0.2, 0.21])
    vc = VirtualClock()
    fe = ServingFrontend(_open_engine(cfg, params, vc))
    fe.submit_workload(wl)
    out = fe.drain()
    assert [out[f] for f in range(len(wl))] == _closed(cfg, params, wl)


# ---------------------------------------------------------------------------
# burst overload soak: preemption + prefix cache + speculation together
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tier", [
    dict(),
    dict(kv_dtype="int8", preempt="swap"),
], ids=["fp-recompute", "int8-swap"])
def test_burst_overload_soak(setup, tier):
    """Bursty agents + chat traffic through a deliberately tight pool with
    every engine feature on at once: preemption fires, the prefix cache
    serves the agents' shared system prompt, speculation accepts drafts —
    and every stream still finishes exactly, leaving the engine empty.
    The int8-swap flavour also requires the swap store to drain."""
    cfg, params = setup
    burst = dict(rate_lo=20.0, rate_hi=400.0, dwell_lo_s=0.25,
                 dwell_hi_s=0.15)
    agents = loadgen.build_workload(mix="agents", arrivals="bursty",
                                    n=250, seed=21, vocab=cfg.vocab,
                                    burst=burst)
    chat = loadgen.build_workload(mix="chat", arrivals="bursty", n=250,
                                  seed=22, vocab=cfg.vocab, burst=burst)
    wl = sorted(agents + chat, key=lambda r: r.t)
    vc = VirtualClock()
    eng = _open_engine(cfg, params, vc, num_blocks=21, token_budget=32,
                       prefix_cache=True, speculate=True, draft_k=4,
                       trace_capacity=8192, **tier)
    fe = ServingFrontend(eng, virtual_tick_s=0.004)
    fids = fe.submit_workload(wl)
    out = fe.drain()
    assert len(out) == len(wl) == 500
    for fid, r in zip(fids, wl):
        fr = fe.result(fid)
        assert not fr.oom and len(fr.tokens) == r.max_new_tokens
    assert eng.scheduler.preemptions_total > 0
    assert eng.prefix_hit_tokens > 0
    assert eng.spec_accepted_total > 0
    assert eng.active == 0 and not eng.scheduler.has_waiting
    assert eng.alloc.snapshot()[0] == 0
    assert not fe._arrivals and not fe._cancel_q
    if tier:
        u = eng.alloc.utilization()
        assert u["swapped_out_pages"] > 0
        assert u["swapped_in_pages"] == u["swapped_out_pages"]
        assert u["host_pages"] == 0
        assert eng.metrics()["swapped_requests_waiting"] == 0


# ---------------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------------
def test_cancel_mid_prefill_releases_pages(setup):
    cfg, params = setup
    vc = VirtualClock()
    eng = _open_engine(cfg, params, vc, max_slots=2, prefill_chunk=4)
    fe = ServingFrontend(eng)
    fid = fe.submit(np.arange(40, dtype=np.int32), 4)
    fe._round()                      # admit + first prefill chunk only
    slot = next(s for s, r in enumerate(eng.slot_req) if r is not None)
    assert eng.slot_phase[slot] == "prefill"
    assert eng.alloc.snapshot()[0] > 0
    assert fe.cancel(fid) is True
    in_use, _cached, free = eng.alloc.snapshot()
    assert in_use == 0 and free == eng.num_blocks - 1
    assert eng.active == 0
    assert fe.drain() == {} and fe.result(fid).cancelled
    spans = [s for s in eng.telemetry.spans.items()
             if s["kind"] == "cancel"]
    assert len(spans) == 1
    assert eng.metrics()["scheduler"]["cancelled"] == 1


def test_cancel_mid_decode_releases_pages(setup):
    cfg, params = setup
    vc = VirtualClock()
    eng = _open_engine(cfg, params, vc, max_slots=2)
    fe = ServingFrontend(eng)
    keep = fe.submit(np.arange(6, dtype=np.int32), 12)
    kill = fe.submit(np.arange(8, dtype=np.int32), 12)
    stream = fe.stream(kill)
    got = [next(stream) for _ in range(3)]
    slot = next(s for s, r in enumerate(eng.slot_req)
                if r is not None
                and r.req_id == fe.result(kill).engine_id)
    assert eng.slot_phase[slot] == "decode"
    assert fe.cancel(kill) is True
    assert eng.slot_req[slot] is None
    assert fe.result(kill).done and fe.result(kill).cancelled
    assert list(stream) == []
    assert fe.result(kill).tokens[:3] == got
    out = fe.drain()
    assert len(out[keep]) == 12
    assert eng.alloc.snapshot()[0] == 0
    assert fe.cancel(kill) is False and fe.cancel(keep) is False


def test_cancel_waiting_and_before_arrival(setup):
    cfg, params = setup
    vc = VirtualClock()
    eng = _open_engine(cfg, params, vc, max_slots=1)
    fe = ServingFrontend(eng)
    a = fe.submit(np.arange(6, dtype=np.int32), 4)
    b = fe.submit(np.arange(6, dtype=np.int32) + 1, 4)
    c = fe.submit(np.arange(6, dtype=np.int32) + 2, 4, at=vc() + 99.0)
    fe._round()
    assert fe.result(b).engine_id is not None
    assert fe.cancel(b) is True and fe.cancel(c) is True
    out = fe.drain()
    assert set(out) == {a} and len(out[a]) == 4
    assert fe.result(c).engine_id is None
    assert eng.metrics()["scheduler"]["cancelled"] == 1


def test_cancel_refused_while_tick_in_flight(setup):
    """A slot-held request cannot be cancelled mid-dispatch (its tokens
    are packed into the running tick); the front end defers instead."""
    cfg, params = setup
    vc = VirtualClock()
    eng = _open_engine(cfg, params, vc, max_slots=2)
    fe = ServingFrontend(eng)
    fid = fe.submit(np.arange(8, dtype=np.int32), 6)
    fe._pump_arrivals()
    pend = eng.step_begin()
    with pytest.raises(RuntimeError, match="in flight"):
        eng.cancel(fe.result(fid).engine_id)
    assert fe.cancel(fid) is True
    assert not fe.result(fid).done
    fe._route(eng.step_end(pend))
    fe._apply_cancels()
    assert fe.result(fid).done and fe.result(fid).cancelled
    assert eng.alloc.snapshot()[0] == 0


# ---------------------------------------------------------------------------
# drain-after-burst leaves everything empty; the trace checks out
# ---------------------------------------------------------------------------
def test_drain_after_burst_clean(setup, tmp_path):
    cfg, params = setup
    wl = loadgen.build_workload(mix="agents", arrivals="bursty", n=40,
                                seed=5, vocab=cfg.vocab)
    vc = VirtualClock()
    eng = _open_engine(cfg, params, vc, num_blocks=40, prefix_cache=True)
    fe = ServingFrontend(eng, virtual_tick_s=0.003)
    fids = fe.submit_workload(wl)
    fe.cancel(fids[7])               # pre-arrival: never reaches the engine
    for _ in range(3):
        fe._round()
    live = next(f for f in fids if fe.result(f).engine_id is not None
                and not fe.result(f).done)
    fe.cancel(live)                  # ...then cancel one engine-side
    out = fe.drain()
    assert set(out) == set(fids) - {fids[7], live}
    assert eng.active == 0 and not eng.scheduler.has_waiting
    assert eng.alloc.snapshot()[0] == 0
    assert not fe._arrivals and not fe._by_engine and not eng.finished
    assert fe.drain() == {}
    path = tmp_path / "openloop.jsonl"
    assert eng.dump_trace(path) == "jsonl"
    done = subprocess.run([sys.executable, "-m", "tools.tracestats",
                           str(path), "--check"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
    assert "checks passed" in done.stdout
    assert '"cancel"' in path.read_text()


# ---------------------------------------------------------------------------
# no-progress guards, and the drain repair
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("unified", [True, False])
def test_stuck_engine_raises_instead_of_spinning(setup, unified):
    """With the pool externally exhausted, admission vacates the slot every
    tick and re-queues the request — zero progress: run_to_completion
    raises at once rather than spinning out its step budget, and the
    front end's drain raises too."""
    cfg, params = setup
    eng = PagedServingEngine(cfg, params, max_slots=1, block_size=4,
                             max_blocks_per_seq=4, num_blocks=4,
                             prefill_chunk=4, unified=unified, device="cpu")
    held = [eng.alloc.allocate() for _ in range(eng.num_blocks - 1)]
    assert all(b is not None for b in held)
    rid = eng.submit(np.arange(8, dtype=np.int32), 2)
    with pytest.raises(RuntimeError, match="no step can make progress"):
        eng.run_to_completion(max_steps=10**9)
    eng.alloc.decref(held)
    results = eng.run_to_completion()
    assert len(results[rid]) == 2
    eng.clear_finished()
    held = [eng.alloc.allocate() for _ in range(eng.num_blocks - 1)]
    fe = ServingFrontend(eng)
    fid = fe.submit(np.arange(6, dtype=np.int32), 2)
    with pytest.raises(RuntimeError, match="no round can make progress"):
        fe.drain()
    eng.alloc.decref(held)
    assert len(fe.drain()[fid]) == 2


def test_drain_retires_cancelled_arrivals(setup):
    """Regression for the JAX front end's drain fault: an idle engine with
    only cancelled arrivals left (at 0, 0, 0.002 and 0.05 s) drains
    cleanly; each retired arrival counts as progress."""
    cfg, params = setup
    vc = VirtualClock()
    eng = _open_engine(cfg, params, vc, max_slots=2)
    fe = ServingFrontend(eng, virtual_tick_s=0.001)
    fids = [fe.submit(np.arange(3, dtype=np.int32), 2, at=vc() + d)
            for d in (0.0, 0.0, 0.002, 0.05)]
    assert all(fe.cancel(f) for f in fids)
    assert fe.drain() == {}
    assert not fe._arrivals and fe.settled_total == 4
    assert all(fe.result(f).done and fe.result(f).engine_id is None
               for f in fids)
    assert vc() >= 0.05 and eng.dispatches == 0


# ---------------------------------------------------------------------------
# step_begin / step_end pairing contract
# ---------------------------------------------------------------------------
def test_step_begin_end_contract(setup):
    cfg, params = setup
    eng = PagedServingEngine(cfg, params, device="cpu", **ENGINE_KW)
    rid = eng.submit(np.arange(6, dtype=np.int32), 4)
    pend = eng.step_begin()
    with pytest.raises(RuntimeError, match="already in flight"):
        eng.step_begin()
    rid2 = eng.submit(np.arange(5, dtype=np.int32), 3)
    emitted = eng.step_end(pend)
    with pytest.raises(RuntimeError, match="without a matching"):
        eng.step_end(pend)
    results = eng.run_to_completion()
    assert len(results[rid]) == 4 and len(results[rid2]) == 3
    with pytest.raises(RuntimeError, match="without a matching"):
        eng.step_end({"kind": "unified"})
    assert isinstance(emitted, dict)


# ---------------------------------------------------------------------------
# hypothesis state machines, derandomised (import-gated like the JAX tests)
# ---------------------------------------------------------------------------
if HAVE_HYPOTHESIS:
    _FUZZ: dict = {}

    def _fuzz_engine(name, **kw):
        """One shared engine per machine across examples: every example must
        leave it spotless for the next, which is itself under test."""
        if name not in _FUZZ:
            cfg = reduced(get_config("granite-3-2b"))
            params = _bridged()[3]
            vc = VirtualClock()
            eng = PagedServingEngine(cfg, params, max_slots=2, block_size=4,
                                     max_blocks_per_seq=8, prefill_chunk=4,
                                     trace_capacity=256, clock=vc, device="cpu",
                                     **kw)
            _FUZZ[name] = (eng, vc)
        return _FUZZ[name]

    class FrontendMachine(RuleBasedStateMachine):
        """Arbitrary submit/stream/cancel/drain interleavings.

        Checked continuously: page conservation and the tick-pairing state.
        Checked at teardown: every request reached exactly one terminal state
        and every non-cancelled stream carries exactly its requested tokens
        (``_harvest_finished`` asserts streamed == emitted on the way)."""

        def _engine(self):
            return _fuzz_engine("fp", num_blocks=12)

        def __init__(self):
            super().__init__()
            self.eng, self.vc = self._engine()
            assert self.eng.active == 0 and not self.eng.scheduler.waiting
            self.fe = ServingFrontend(self.eng, virtual_tick_s=0.001)
            self.expect: dict = {}

        @rule(plen=st.integers(1, 6), gen=st.integers(1, 3),
              delay=st.sampled_from([0.0, 0.002, 0.05]))
        def submit(self, plen, gen, delay):
            prompt = np.arange(plen, dtype=np.int32) % 17
            fid = self.fe.submit(prompt, gen, at=self.vc() + delay)
            self.expect[fid] = gen

        @precondition(lambda self: self.fe._has_work())
        @rule()
        def tick(self):
            self.fe._round()

        @precondition(lambda self: any(
            not fr.done and not fr.cancelled for fr in self.fe._reqs.values()))
        @rule(pick=st.integers(0, 10**6))
        def cancel(self, pick):
            live = [fid for fid, fr in self.fe._reqs.items()
                    if not fr.done and not fr.cancelled]
            assert self.fe.cancel(live[pick % len(live)])

        @rule(n=st.integers(1, 4))
        def stream_some(self, n):
            live = [fid for fid, fr in self.fe._reqs.items()
                    if not fr.done and not fr.cancelled]
            if not live:
                return
            it = self.fe.stream(live[0])
            for _ in range(n):
                if next(it, None) is None:
                    break

        @rule()
        def drain(self):
            self.fe.drain()

        @invariant()
        def pages_conserved(self):
            in_use, cached, free = self.eng.alloc.snapshot()
            assert in_use + cached + free == self.eng.num_blocks - 1
            assert self.eng._pending is None

        def teardown(self):
            self.fe.drain()
            for fid, gen in self.expect.items():
                fr = self.fe.result(fid)
                assert fr.done, f"req {fid} lost its finish event"
                if not fr.cancelled:
                    assert len(fr.tokens) == gen, fid
            assert self.eng.active == 0
            assert not self.eng.scheduler.waiting
            assert self.eng.alloc.snapshot()[0] == 0
            self.eng.clear_finished()

    FrontendMachine.TestCase.settings = settings(
        max_examples=12, stateful_step_count=20, **FUZZ)
    TestFrontendFuzz = FrontendMachine.TestCase

    class SwapFrontendMachine(FrontendMachine):
        """The same interleavings over int8 pages, swap preemption and the
        host prefix tier in a pool tight enough that swaps fire: the swap
        store never holds a payload without a waiting owner, and drains."""

        def _engine(self):
            return _fuzz_engine("swap", num_blocks=9, kv_dtype="int8",
                                preempt="swap", prefix_cache=True,
                                host_cache_pages=4)

        @invariant()
        def swap_store_owned(self):
            assert (len(self.eng._swap_handles)
                    == len(self.eng.alloc._swap_store))

        def teardown(self):
            super().teardown()
            assert not self.eng.alloc._swap_store
            assert self.eng.metrics()["swapped_requests_waiting"] == 0

    SwapFrontendMachine.TestCase.settings = settings(
        max_examples=8, stateful_step_count=20, **FUZZ)
    TestSwapFrontendFuzz = SwapFrontendMachine.TestCase
