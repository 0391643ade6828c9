"""The port's replica router (``repro_torch.serving.router``) on the CPU,
ported from ``tests/test_router.py`` and the router parts of
``tests/test_obs.py``, and held to the JAX package.

What is pinned here:

  * routing is a *placement* change, never a *token* change: streams
    served through a ``ReplicaRouter`` (round-robin or prefix-affinity, 1
    to 3 replicas) are byte-identical to one engine serving the same
    requests, and one router run places and serves exactly as the JAX
    router does on the same (bridged) weights;
  * prefix-affinity placement follows the warm replica and the anti-herd
    pressure cap demotes a hot replica to pressure balancing;
  * elasticity: a mid-traffic ``resize()`` up and down, an injected
    replica preemption and a failed replica holding a swapped-out request
    re-route every in-flight request with zero drops and byte-identical
    streams; evacuated pages (CPU torch tensors) migrate into the
    survivor's host prefix cache and are restored from it;
  * ``ServingFrontend.cancel()`` of a stale handle settles idempotently,
    and the front end over a fleet drains the JAX router fuzz's shrunk
    failing sequence (cancelled arrivals only) cleanly;
  * merged multi-replica traces pass ``tools/tracestats.py --check``
    (run as a subprocess);
  * ``Platform.serve_on_cluster(replicas=2)`` through the verbs;
  * a derandomised hypothesis state machine over join / leave / fail /
    cancel / stream / drain (not held to the JAX machine, which fails).
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
from repro.serving import ReplicaRouter as JaxReplicaRouter
from repro.serving import VirtualClock as JaxVirtualClock
from repro_torch.config import get_config, reduced
from repro_torch.ft.preemption import PreemptionSchedule
from repro_torch.launch.serve import generate
from repro_torch.serving import (PagedServingEngine, ReplicaRouter,
                                 ServingFrontend, VirtualClock)
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
CPU = torch.device("cpu")


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


FACTORY_KW = dict(max_slots=4, block_size=4, max_blocks_per_seq=16,
                  num_blocks=64, prefill_chunk=8)


def _factory(cfg, params, vc, **kw):
    kw = dict(FACTORY_KW, **kw)

    def build(i):
        return PagedServingEngine(cfg, params, clock=vc, device="cpu", **kw)

    return build


def _prompts(cfg, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab,
                         size=int(rng.integers(3, 14))).astype(np.int32)
            for _ in range(n)]


def _reference(build, prompts, gen=6):
    eng = build(0)
    ids = [eng.submit(p, gen) for p in prompts]
    out = eng.run_to_completion()
    return [out[r] for r in ids]


def _tracestats_check(path):
    done = subprocess.run([sys.executable, "-m", "tools.tracestats",
                           str(path), "--check"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
    return done.stdout


# ---------------------------------------------------------------------------
# routing is placement-only: byte-identical streams
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("routing", ["rr", "affinity"])
def test_router_byte_identity(setup, routing, n):
    cfg, params = setup
    vc = VirtualClock()
    build = _factory(cfg, params, vc, prefix_cache=True,
                     host_cache_pages=16)
    prompts = _prompts(cfg)
    ref = _reference(build, prompts)
    assert ref[0] == generate(cfg, params, torch.from_numpy(prompts[0])[None],
                              6)[0, len(prompts[0]):].tolist()
    rt = ReplicaRouter(build, n, routing=routing)
    ids = [rt.submit(p, 6) for p in prompts]
    out = rt.run_to_completion()
    assert [out[r] for r in ids] == ref
    m = rt.metrics()
    assert m["fleet"]["replicas"] == n
    assert m["fleet"]["finished"] == len(prompts)
    assert sum(m["fleet"]["placements"].values()) == len(prompts)
    assert m["fleet"]["queue_depth"] == 0
    assert len(m["replicas"]) == n


def test_router_run_matches_jax(bridged):
    """The same traffic (a shared system prompt re-served after a warm-up,
    mid-flight submissions) through the JAX router and the port's: the
    same streams, placements, affinity hits and fleet rollup."""
    jcfg, jparams, cfg, params = bridged
    sys_prompt = np.arange(16, dtype=np.int32) % 23
    first = [np.concatenate([sys_prompt, np.asarray([1, 2], np.int32)])]
    later = [np.concatenate([sys_prompt, np.asarray(t, np.int32)])
             for t in ([3, 4], [5], [6, 7, 8])] + _prompts(cfg, 4, seed=8)
    kw = dict(FACTORY_KW, prefix_cache=True, host_cache_pages=16)
    runs = []
    for make, Clock, Router in (
            (lambda vc: JaxPagedServingEngine(jcfg, jparams, clock=vc, **kw),
             JaxVirtualClock, JaxReplicaRouter),
            (lambda vc: PagedServingEngine(cfg, params, clock=vc,
                                           device="cpu", **kw),
             VirtualClock, ReplicaRouter)):
        vc = Clock()
        rt = Router(lambda i, vc=vc, make=make: make(vc), 2,
                    routing="affinity")
        ids = [rt.submit(p, 5) for p in first]
        rt.run_to_completion()
        ids += [rt.submit(p, 5) for p in later[:3]]
        rt.step()
        ids += [rt.submit(p, 5) for p in later[3:]]
        out = rt.run_to_completion()
        fleet = rt.metrics()["fleet"]
        runs.append(([out[i] for i in ids],
                     [rt.finished[i].replica for i in ids], fleet))
    (jout, jrep, jfleet), (out, rep, fleet) = runs
    assert out == jout
    assert rep == jrep
    assert fleet == jfleet and fleet["affinity_hit_tokens"] >= 3 * 16


def test_affinity_follows_warm_replica(setup):
    cfg, params = setup
    vc = VirtualClock()
    build = _factory(cfg, params, vc, prefix_cache=True,
                     host_cache_pages=16)
    rt = ReplicaRouter(build, 2, routing="affinity")
    sys_prompt = (np.arange(16, dtype=np.int32) % 23)
    warm = np.concatenate([sys_prompt, np.asarray([1, 2], np.int32)])
    rid = rt.submit(warm, 4)
    rt.run_to_completion()
    seed_replica = rt.finished[rid].replica
    for tail in ([3, 4], [5], [6, 7, 8]):
        probe = np.concatenate([sys_prompt, np.asarray(tail, np.int32)])
        rid = rt.submit(probe, 4)
        assert rt._live[rid].replica == seed_replica
    assert rt.placements["affinity"] == 3
    assert rt.affinity_hit_tokens >= 3 * 16
    rt.run_to_completion()
    hits = rt.metrics()["replicas"][seed_replica]["prefix_cache"]
    assert hits["hit_tokens"] > 0


def test_pressure_cap_demotes_hot_replica(setup):
    cfg, params = setup
    vc = VirtualClock()
    build = _factory(cfg, params, vc, prefix_cache=True, max_slots=2)
    rt = ReplicaRouter(build, 2, routing="affinity", pressure_cap=0.25)
    sys_prompt = (np.arange(16, dtype=np.int32) % 23)
    warm = np.concatenate([sys_prompt, np.asarray([1, 2], np.int32)])
    rid = rt.submit(warm, 4)
    rt.run_to_completion()
    hot = rt.finished[rid].replica
    for i in range(2):
        rt.replicas[hot].submit(np.asarray([100 + i], np.int32), 2)
    probe = np.concatenate([sys_prompt, np.asarray([3], np.int32)])
    rid2 = rt.submit(probe, 4)
    assert rt._live[rid2].replica != hot
    assert rt.placements["affinity"] == 0
    assert rt.placements["balanced"] >= 1
    rt.run_to_completion()


# ---------------------------------------------------------------------------
# elasticity: resize up/down, injected preemption, a failed replica
# ---------------------------------------------------------------------------
def test_resize_mid_traffic_zero_drops(setup):
    cfg, params = setup
    vc = VirtualClock()
    build = _factory(cfg, params, vc, prefix_cache=True,
                     host_cache_pages=32)
    prompts = _prompts(cfg)
    ref = _reference(build, prompts)
    rt = ReplicaRouter(build, 2)
    ids = [rt.submit(p, 6) for p in prompts]
    for _ in range(3):
        rt.step()
    assert rt.resize(4) == 4
    for _ in range(2):
        rt.step()
    assert rt.resize(1) == 1 and len(rt.replicas) == 1
    out = rt.run_to_completion()
    assert [out[r] for r in ids] == ref
    assert rt.rerouted_total > 0
    assert all(not p.oom and not p.cancelled
               for p in rt.finished.values())
    m = rt.metrics()["fleet"]
    assert m["resizes"] == 2 and m["replicas"] == 1


def test_evacuation_migrates_pages_to_survivor(setup):
    cfg, params = setup
    vc = VirtualClock()
    build = _factory(cfg, params, vc, prefix_cache=True,
                     host_cache_pages=32)
    rt = ReplicaRouter(build, 2, routing="rr")
    prompts = _prompts(cfg, n=2, seed=3)
    ref = _reference(build, prompts, gen=8)
    ids = [rt.submit(p, 8) for p in prompts]
    for _ in range(4):
        rt.step()
    rt.resize(1)
    assert rt.migrated_pages > 0
    host = rt.replicas[0].alloc._host_cache
    assert host and all(isinstance(t, torch.Tensor) and t.device == CPU
                        and t.shape[1] == 1
                        for payload in host.values()
                        for t in payload.values())
    out = rt.run_to_completion()
    assert [out[r] for r in ids] == ref
    assert rt.replicas[0].alloc.host_cache_hits > 0


def test_failed_replica_migrates_swapped_payload(setup):
    """A replica fails while it holds a request swapped out to host RAM:
    the swap payload (CPU torch tensors) is sliced page by page into the
    survivor's host tier, and every stream stays byte-identical."""
    cfg, params = setup
    vc = VirtualClock()
    build = _factory(cfg, params, vc, max_slots=2, num_blocks=9,
                     prefill_chunk=4, preempt="swap", prefix_cache=True,
                     host_cache_pages=32)
    prompts = _prompts(cfg, n=6, seed=12)
    ref = _reference(build, prompts, gen=12)
    rt = ReplicaRouter(build, 2, routing="rr")
    ids = [rt.submit(p, 12) for p in prompts]
    victim = None
    for _ in range(200):
        rt.step()
        victim = next((i for i, e in enumerate(rt.replicas)
                       if e._swap_handles), None)
        if victim is not None:
            break
    assert victim is not None, "no request was swapped out"
    before = rt.migrated_pages
    rt.fail_replica(victim)
    assert rt.migrated_pages > before
    out = rt.run_to_completion()
    assert [out[r] for r in ids] == ref
    assert rt.replica_failures == 1 and rt.rerouted_total > 0
    for eng in rt.replicas:
        assert not eng._swap_handles and eng.alloc.snapshot()[0] == 0


def test_injected_preemption_schedule(setup):
    cfg, params = setup
    vc = VirtualClock()
    build = _factory(cfg, params, vc, prefix_cache=True,
                     host_cache_pages=32)
    prompts = _prompts(cfg)
    ref = _reference(build, prompts)
    rt = ReplicaRouter(build, 2,
                       preemption=PreemptionSchedule(kill_at_steps=[4]))
    ids = [rt.submit(p, 6) for p in prompts]
    out = rt.run_to_completion()
    assert [out[r] for r in ids] == ref
    assert rt.replica_failures == 1
    assert len(rt.replicas) == 2
    assert rt.rerouted_total > 0


def test_router_guards(setup):
    cfg, params = setup
    vc = VirtualClock()
    build = _factory(cfg, params, vc)
    with pytest.raises(ValueError, match="routing"):
        ReplicaRouter(build, 2, routing="random")
    with pytest.raises(ValueError, match="replicas"):
        ReplicaRouter(build, 0)
    sizes = iter([64, 32])

    def uneven(i):
        return PagedServingEngine(cfg, params, max_slots=4, block_size=4,
                                  max_blocks_per_seq=16,
                                  num_blocks=next(sizes), clock=vc,
                                  device="cpu")
    with pytest.raises(ValueError, match="homogeneous"):
        ReplicaRouter(uneven, 2)
    devices = iter(["cpu", "meta"])

    class Elsewhere:
        """An engine stand-in on another device type."""
        block_size, num_blocks, capacity_tokens, max_slots = 4, 64, 64, 4

        def __init__(self, device):
            self.device = torch.device(device)

    def mixed(i):
        d = next(devices)
        return build(i) if d == "cpu" else Elsewhere(d)
    with pytest.raises(ValueError, match="runs on meta"):
        ReplicaRouter(mixed, 2)
    rt = ReplicaRouter(build, 1)
    with pytest.raises(RuntimeError, match="only replica"):
        rt.fail_replica(0)
    rt.submit(np.arange(4, dtype=np.int32), 2)
    pend = rt.step_begin()
    with pytest.raises(RuntimeError, match="in flight"):
        rt.step_begin()
    with pytest.raises(RuntimeError, match="in flight"):
        rt.resize(2)
    rt.step_end(pend)
    rt.run_to_completion()
    assert rt.cancel(999) is False


# ---------------------------------------------------------------------------
# front end over the router
# ---------------------------------------------------------------------------
def test_frontend_over_router_byte_identity(setup):
    cfg, params = setup
    vc = VirtualClock()
    build = _factory(cfg, params, vc)
    prompts = _prompts(cfg, n=6, seed=1)
    ref = _reference(build, prompts)
    rt = ReplicaRouter(build, 2)
    fe = ServingFrontend(rt, virtual_tick_s=0.001)
    fids = [fe.submit(p, 6, at=vc() + 0.001 * i)
            for i, p in enumerate(prompts)]
    fe.drain()
    assert [fe.result(f).tokens for f in fids] == ref
    assert rt.active == 0 and not rt._live


def test_frontend_cancel_rerouted_request(setup):
    cfg, params = setup
    vc = VirtualClock()
    build = _factory(cfg, params, vc)
    rt = ReplicaRouter(build, 2, routing="rr")
    fe = ServingFrontend(rt, virtual_tick_s=0.001)
    fids = [fe.submit(np.arange(6, dtype=np.int32) + i, 8)
            for i in range(4)]
    for _ in range(3):
        fe._round()
    rt.resize(1)
    live = [f for f in fids if not fe.result(f).done]
    assert live
    for f in live:
        assert fe.cancel(f)
    fe.drain()
    for f in fids:
        assert fe.result(f).done


def test_frontend_stale_cancel_idempotent(setup):
    cfg, params = setup
    vc = VirtualClock()
    eng = _factory(cfg, params, vc)(0)
    fe = ServingFrontend(eng, virtual_tick_s=0.001)
    fid = fe.submit(np.arange(5, dtype=np.int32), 3)
    while fe.result(fid).engine_id is None:
        fe._round()
    eng.cancel(fe.result(fid).engine_id)
    eng.clear_finished()
    assert fe.cancel(fid) is True
    fr = fe.result(fid)
    assert fr.done and fr.cancelled
    assert fe.cancel(fid) is False
    assert list(fe.stream(fid)) == fr.tokens
    fe.drain()


def test_router_drains_the_fuzz_failure(setup):
    """The JAX router fuzz's shrunk failing sequence, on the port:
    ``fail(0)``; four submits at delays 0, 0, 0.002 and 0.05 s, each
    cancelled before it arrives; ``fail(0)``; ``drain()``.  The JAX front
    end raises "no round can make progress" here; the port's drains."""
    cfg, params = setup
    vc = VirtualClock()
    rt = ReplicaRouter(_factory(cfg, params, vc, max_slots=2,
                                max_blocks_per_seq=8, num_blocks=16,
                                prefill_chunk=4, prefix_cache=True,
                                host_cache_pages=8), 2)
    fe = ServingFrontend(rt, virtual_tick_s=0.001)
    rt.fail_replica(0)
    fids = []
    for delay in (0.0, 0.0, 0.002, 0.05):
        fids.append(fe.submit(np.arange(1, dtype=np.int32) % 17, 1,
                              at=vc() + delay))
        assert fe.cancel(fids[-1])
    rt.fail_replica(0)
    assert fe.drain() == {}
    assert all(fe.result(f).done and fe.result(f).cancelled for f in fids)
    assert not fe._arrivals and rt.active == 0 and not rt._live
    assert rt.replica_failures == 2


# ---------------------------------------------------------------------------
# merged traces / platform
# ---------------------------------------------------------------------------
def test_merged_trace_checks(setup, tmp_path):
    sys.path.insert(0, REPO)
    from tools import tracestats
    cfg, params = setup
    vc = VirtualClock()
    build = _factory(cfg, params, vc, prefix_cache=True)
    rt = ReplicaRouter(build, 2)
    for p in _prompts(cfg, n=6, seed=2):
        rt.submit(p, 5)
    rt.run_to_completion()
    with pytest.raises(ValueError, match="JSONL"):
        rt.dump_trace(tmp_path / "t.json")
    path = tmp_path / "t.jsonl"
    assert rt.dump_trace(path) == "jsonl"
    meta, ticks, spans, fmt = tracestats.load(str(path))
    assert fmt == "jsonl" and meta["merged"]
    parts = tracestats.split_replicas(meta, ticks, spans)
    assert set(parts) == {0, 1}
    for i, (m, tk, sp) in parts.items():
        assert tk, f"replica {i} recorded no ticks"
    assert "checks passed (merged" in _tracestats_check(path)


def test_serve_on_cluster_replicas(setup, tmp_path):
    from repro_torch.core.platform import Platform
    from repro_torch.core.resources import DevicePool
    cfg, params = setup
    reqs = [(np.arange(5, dtype=np.int32) + i, 4) for i in range(4)]
    kw = dict(max_slots=2, block_size=4, max_blocks_per_seq=8,
              prefix_cache=True)
    plat = Platform(tmp_path / "ws", pool=DevicePool([CPU]))
    plat.create_cluster("fleet", 1, model_axis=1)
    try:
        one = plat.serve_on_cluster("fleet", cfg, params, reqs,
                                    runname="one", **kw).result
        two = plat.serve_on_cluster("fleet", cfg, params, reqs,
                                    runname="two", replicas=2,
                                    routing="rr",
                                    trace=str(tmp_path / "fleet.jsonl"),
                                    **kw).result
    finally:
        plat.terminate_cluster("fleet")
    assert list(two["results"].values()) == list(one["results"].values())
    fleet = two["metrics"]["fleet"]
    assert fleet["replicas"] == 2 and fleet["finished"] == len(reqs)
    assert fleet["routing"] == "rr" and fleet["placements"]["rr"] == 4
    assert len(two["metrics"]["replicas"]) == 2
    assert two["metrics"]["trace"]["format"] == "jsonl"
    _tracestats_check(tmp_path / "fleet.jsonl")


# ---------------------------------------------------------------------------
# hypothesis state machine: join/leave/fail/cancel/re-route, derandomised
# ---------------------------------------------------------------------------
if HAVE_HYPOTHESIS:
    _RFUZZ: dict = {}

    def _router_env():
        """Shared engine pool across examples: retired replicas are
        recycled through the router's ``retire`` hook, and every example
        must hand back clean engines."""
        if not _RFUZZ:
            cfg = reduced(get_config("granite-3-2b"))
            params = _bridged()[3]
            vc = VirtualClock()
            pool: list = []

            def factory(i):
                if pool:
                    return pool.pop()
                return PagedServingEngine(
                    cfg, params, max_slots=2, block_size=4,
                    max_blocks_per_seq=8, num_blocks=16,
                    prefill_chunk=4, trace_capacity=256,
                    prefix_cache=True, host_cache_pages=8, clock=vc,
                    device="cpu")

            _RFUZZ.update(vc=vc, pool=pool, factory=factory)
        return _RFUZZ

    class RouterMachine(RuleBasedStateMachine):
        """Arbitrary submit/tick/cancel/stream/resize/fail/drain
        interleavings over a 1-3 replica fleet: pages conserved per
        replica; at teardown every request reached exactly one terminal
        state and every non-cancelled stream carries exactly its tokens,
        across any number of re-routes."""

        def __init__(self):
            super().__init__()
            env = _router_env()
            self.vc, self.pool = env["vc"], env["pool"]
            self.rt = ReplicaRouter(env["factory"], 2,
                                    retire=self.pool.append)
            self.fe = ServingFrontend(self.rt, virtual_tick_s=0.001)
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

        @rule(n=st.integers(1, 3))
        def resize(self, n):
            self.rt.resize(n)

        @precondition(lambda self: len(self.rt.replicas) >= 2)
        @rule(pick=st.integers(0, 10**6))
        def fail(self, pick):
            self.rt.fail_replica(pick % len(self.rt.replicas))

        @precondition(lambda self: any(
            not fr.done and not fr.cancelled
            for fr in self.fe._reqs.values()))
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
        def pages_conserved_per_replica(self):
            assert self.rt._pending is None
            for eng in self.rt.replicas:
                in_use, cached, free = eng.alloc.snapshot()
                assert in_use + cached + free == eng.num_blocks - 1

        def teardown(self):
            self.fe.drain()
            for fid, gen in self.expect.items():
                fr = self.fe.result(fid)
                assert fr.done, f"req {fid} lost its finish event"
                if not fr.cancelled:
                    assert len(fr.tokens) == gen, fid
            assert self.rt.active == 0 and not self.rt._live
            for eng in self.rt.replicas:
                assert eng.active == 0
                assert not eng.scheduler.waiting
                assert eng.alloc.snapshot()[0] == 0
                assert not eng._swap_handles
            self.rt.clear_finished()
            self.pool.extend(self.rt.replicas)

    RouterMachine.TestCase.settings = settings(
        max_examples=10, stateful_step_count=18, derandomize=True,
        database=None, deadline=None)
    TestRouterFuzz = RouterMachine.TestCase
