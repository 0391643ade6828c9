"""The port's host capacity tiers on the CPU, ported from
``tests/test_capacity_tiers.py`` (swap preemption and the host prefix
cache) and ``tests/test_prefix_cache.py`` (the allocator's units and the
eviction cases), and held to the JAX engine.

Contracts under test:

  * ``preempt="swap"`` changes scheduling, never tokens: under a contended
    pool the streams equal ``preempt="recompute"``'s, the port's isolated
    ``generate`` and the JAX engine's, with the prefix cache, speculation
    and int8 pools stacked on top, and under a per-tick swap budget; a
    parked page comes back bit for bit, int8 scales included;
  * the host tiers drain: no payload is left parked after a run, and
    cancelling a swapped-out waiting request discards its payload;
  * evicted zero-ref prefix-cache pages spill to the bounded host cache
    and a later prompt match restores them, with the JAX engine's
    counters;
  * the allocator: ref counts, the hash index and its LRU, dedup, the
    shared predicate, byte accounting, fork and copy-on-write, and the
    engine's eviction cases;
  * the CLI's ``--speculate``, ``--draft-k``, ``--preempt`` and
    ``--host-cache-pages`` reach the engine.

Output projections are scaled as in ``test_torch_paged_serving`` so that
streams vary.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduced as jax_reduced
from repro.models import model as JM
from repro.serving import PagedServingEngine as JaxPagedServingEngine
from repro_torch.config import get_config, reduced
from repro_torch.launch.serve import generate
from repro_torch.serving import BlockAllocator, PagedServingEngine
from repro_torch.serving.blocks import BlockTable, page_digest
from repro_torch.weights import params_from_numpy

BRANCH_GAIN = 8.0        # see test_torch_paged_serving


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
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


def _ref(cfg, params, prompt, gen):
    out = generate(cfg, params, torch.from_numpy(prompt)[None], gen)
    return out[0, len(prompt):].tolist()


def _prompts(cfg, n=6, lo=9, hi=15, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, cfg.vocab, size=int(k)).astype(np.int32)
            for k in rng.integers(lo, hi, size=n)]


CONTENDED = dict(max_slots=3, block_size=4, max_blocks_per_seq=10,
                 num_blocks=13)      # serving 6 requests preempts several


def _serve(eng, prompts, gen=16):
    ids = [eng.submit(p, gen) for p in prompts]
    out = eng.run_to_completion()
    return [out[i] for i in ids]


def _port(cfg, params, **kw):
    return PagedServingEngine(cfg, params, device="cpu",
                              **dict(CONTENDED, **kw))


def _jax(jcfg, jparams, **kw):
    return JaxPagedServingEngine(jcfg, jparams, **dict(CONTENDED, **kw))


# ---------------------------------------------------------------------------
# swap == recompute == generate == the JAX engine
# ---------------------------------------------------------------------------

def test_swap_byte_identical_and_drains(setup):
    jcfg, jparams, cfg, params = setup
    prompts = _prompts(cfg)
    eng_r = _port(cfg, params, preempt="recompute")
    eng_s = _port(cfg, params, preempt="swap")
    jeng = _jax(jcfg, jparams, preempt="swap")
    out_r, out_s = _serve(eng_r, prompts), _serve(eng_s, prompts)
    assert out_s == out_r == _serve(jeng, prompts)
    assert eng_s.scheduler.preemptions_total > 0
    u = eng_s.alloc.utilization()
    assert u["swapped_out_pages"] > 0
    assert u["swapped_in_pages"] == u["swapped_out_pages"]
    for p, toks in zip(prompts, out_s):
        assert toks == _ref(cfg, params, p, 16)
    # the same schedule as the JAX engine: page and swap counters equal
    assert u == jeng.alloc.utilization()
    assert eng_s.dispatches == jeng.dispatches
    assert u["host_pages"] == 0
    assert eng_s.metrics()["swapped_requests_waiting"] == 0
    assert eng_s.metrics()["preempt"] == "swap"
    assert eng_s.alloc.snapshot()[0] == 0
    assert set(eng_s.metrics()) == set(jeng.metrics())


@pytest.mark.parametrize("unified", [True, False], ids=["unified", "legacy"])
def test_swap_with_prefix_cache_and_speculation_int8(setup, unified):
    """The full stack at once: int8 pools, the prefix cache, speculation
    and swap preemption: swapped streams equal recomputed ones and the
    JAX engine's, with its drafted and swapped totals."""
    jcfg, jparams, cfg, params = setup
    prompts = _prompts(cfg, seed=3)
    kw = dict(kv_dtype="int8", prefix_cache=True, speculate=True,
              draft_k=2, unified=unified)
    out_r = _serve(_port(cfg, params, preempt="recompute", **kw), prompts)
    eng_s = _port(cfg, params, preempt="swap", **kw)
    jeng = _jax(jcfg, jparams, preempt="swap", **kw)
    out_s = _serve(eng_s, prompts)
    assert out_s == out_r == _serve(jeng, prompts)
    u = eng_s.alloc.utilization()
    assert u["swapped_out_pages"] > 0
    assert u["swapped_out_pages"] == \
        jeng.alloc.utilization()["swapped_out_pages"]
    assert eng_s.metrics()["speculative"] == jeng.metrics()["speculative"]
    assert eng_s.alloc.snapshot()[0] == 0


def test_swap_budget_still_exact(setup):
    """A per-tick swap-in budget changes pacing, never tokens."""
    jcfg, jparams, cfg, params = setup
    prompts = _prompts(cfg, seed=7)
    out_r = _serve(_port(cfg, params, preempt="recompute"), prompts)
    eng_s = _port(cfg, params, preempt="swap", swap_pages_per_tick=2)
    jeng = _jax(jcfg, jparams, preempt="swap", swap_pages_per_tick=2)
    assert _serve(eng_s, prompts) == out_r == _serve(jeng, prompts)
    assert eng_s.alloc.utilization() == jeng.alloc.utilization()
    assert eng_s.metrics()["swapped_requests_waiting"] == 0
    assert eng_s.alloc.host_pages == 0


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_swap_round_trip_is_bit_equal(setup, kv_dtype):
    """A parked payload covers every pool (int8: both scale pools too) and
    comes back bit for bit into other pages; no other page moves."""
    _, _, cfg, params = setup
    eng = _port(cfg, params, kv_dtype=kv_dtype, preempt="swap")
    for name, pool in eng.cache.items():
        gen = torch.Generator().manual_seed(len(name))
        if pool.dtype == torch.int8:
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=gen,
                                     dtype=torch.int8))
        else:
            pool.copy_(torch.randn(pool.shape, generator=gen))
    src, dst = [3, 7, 5], [2, 9, 11]
    before = {n: p.clone() for n, p in eng.cache.items()}
    payload = eng._pages_to_host(src)
    assert set(payload) == set(eng.cache)
    assert {n: t.device.type for n, t in payload.items()} == \
        {n: "cpu" for n in eng.cache}
    eng._pages_from_host(dst, payload)
    keep = [b for b in range(eng.num_blocks) if b not in dst]
    for name, pool in eng.cache.items():
        assert torch.equal(pool[:, dst], before[name][:, src]), name
        assert torch.equal(pool[:, keep], before[name][:, keep]), name


def test_cancel_swapped_waiting_discards_payload(setup):
    """Cancelling a request whose pages are parked in host RAM frees the
    parked payload."""
    _, _, cfg, params = setup
    prompts = _prompts(cfg, n=5, seed=17)
    eng = _port(cfg, params, preempt="swap")
    ids = [eng.submit(p, 16) for p in prompts]
    victim = None
    for _ in range(200):
        eng.step()
        if eng.metrics()["swapped_requests_waiting"]:
            victim = next(r.req_id for r in eng.scheduler.waiting
                          if r.req_id in eng._swap_handles)
            break
    assert victim is not None, "contention never swapped a waiter"
    assert eng.alloc.host_pages > 0
    assert eng.cancel(victim)
    assert victim not in eng._swap_handles
    out = eng.run_to_completion()
    assert set(out) == set(ids)
    assert eng.finished[victim].cancelled
    for rid, p in zip(ids, prompts):
        if rid != victim:
            assert out[rid] == _ref(cfg, params, p, 16)
    assert eng.alloc.host_pages == 0
    assert eng.alloc.snapshot()[0] == 0


# ---------------------------------------------------------------------------
# the host tier of the prefix cache
# ---------------------------------------------------------------------------

def _churn(eng, cfg):
    """Two prefix groups served in alternating waves through a pool too
    small to keep the idle group's cached pages resident, so that each
    return wave re-prefills (no host tier) or restores spilled pages."""
    rng = np.random.default_rng(13)
    pre = {g: rng.integers(3, cfg.vocab, 8).astype(np.int32) for g in "ab"}
    streams, prompts = [], []
    for g in "abab":
        wave = [np.concatenate([pre[g], rng.integers(3, cfg.vocab, 6 + j)
                                .astype(np.int32)]) for j in range(2)]
        streams += _serve(eng, wave, 8)
        prompts += wave
        eng.clear_finished()
    return streams, prompts


def test_host_cache_spill_and_restore(setup):
    jcfg, jparams, cfg, params = setup
    kw = dict(max_slots=2, block_size=4, max_blocks_per_seq=10,
              num_blocks=12, prefix_cache=True)
    eng0 = PagedServingEngine(cfg, params, device="cpu", **kw)
    eng8 = PagedServingEngine(cfg, params, device="cpu", host_cache_pages=8,
                              **kw)
    jeng8 = JaxPagedServingEngine(jcfg, jparams, host_cache_pages=8, **kw)
    streams0, prompts = _churn(eng0, cfg)
    streams8, _ = _churn(eng8, cfg)
    assert streams8 == streams0 == _churn(jeng8, cfg)[0]
    assert streams8 == [_ref(cfg, params, p, 8) for p in prompts]
    u0, u8 = eng0.alloc.utilization(), eng8.alloc.utilization()
    assert u0["host_cache_capacity_pages"] == 0
    assert u8["host_cache_capacity_pages"] == 8
    assert u8["host_cache_spills"] > 0 and u8["host_cache_hits"] > 0
    assert u8 == jeng8.alloc.utilization()
    assert eng8.metrics()["prefix_cache"] == jeng8.metrics()["prefix_cache"]
    assert eng8.prefix_hit_tokens > 0
    assert u8["host_cache_pages"] <= 8
    assert eng8.alloc.snapshot()[0] == 0


def test_host_restore_is_bit_equal_to_the_spilled_page(setup):
    """Evicting a cached page spills its bytes in every pool (int8: the
    scale pools too); after the device page is reused and clobbered, a
    restore copies them into a fresh page bit for bit and parks it
    attachable under its digest."""
    _, _, cfg, params = setup
    eng = PagedServingEngine(cfg, params, device="cpu", max_slots=1,
                             block_size=4, max_blocks_per_seq=4,
                             num_blocks=6, prefix_cache=True,
                             kv_dtype="int8", host_cache_pages=4)
    prompt = np.arange(3, 12, dtype=np.int32)       # two full pages + 1
    eng.submit(prompt, 2)
    eng.run_to_completion()
    digest = page_digest(b"", prompt[:4])
    blk = eng.alloc.lookup(digest)
    assert blk is not None
    page = {n: p[:, blk].clone() for n, p in eng.cache.items()}
    taken = []
    while eng.alloc.lookup(digest) is not None:     # evict it: spill
        taken.append(eng.alloc.allocate())
    assert blk in taken
    assert eng.alloc.utilization()["host_cache_spills"] >= 1
    for pool in eng.cache.values():
        pool[:, taken] = 0                          # reuse clobbers it
    eng.alloc.decref(taken)
    new = eng._restore_host_page(digest)
    assert new is not None and eng.alloc.lookup(digest) == new
    for name, pool in eng.cache.items():
        assert torch.equal(pool[:, new], page[name]), name
    assert eng.alloc.utilization()["host_cache_hits"] == 1


def test_host_restore_never_evicts_a_matched_page(setup):
    """A re-served prompt whose system-prompt pages are cached zero-ref and
    whose suffix pages sit in the host tier, in a pool with no free page:
    each restore must evict some other cached page, never one the prefix
    walk already matched (it would back two positions of the table).  The
    streams equal the cache off and ``generate``, the whole prompt but its
    last token served from the caches.  (The JAX engine takes the LRU
    page here, the matched system-prompt page, and serves other tokens
    for the re-served prompt.)"""
    _, _, cfg, params = setup
    rng = np.random.default_rng(3)
    sysp = rng.integers(0, cfg.vocab, 12).astype(np.int32)     # 3 pages
    two = [np.concatenate([sysp, rng.integers(0, cfg.vocab, 28)
                           .astype(np.int32)]) for _ in range(2)]
    prompts = [two[0], two[1], two[0].copy()]
    kw = dict(max_slots=1, block_size=4, max_blocks_per_seq=11,
              num_blocks=12, prefill_chunk=3)
    outs = []
    for extra in (dict(), dict(prefix_cache=True, host_cache_pages=8)):
        eng = PagedServingEngine(cfg, params, device="cpu", **kw, **extra)
        outs.append([_serve(eng, [p], 2)[0] for p in prompts])
    assert outs[1] == outs[0] == [_ref(cfg, params, p, 2) for p in prompts]
    u = eng.alloc.utilization()
    assert u["host_cache_hits"] == 7            # the suffix's 7 pages
    assert eng.metrics()["prefix_cache"]["hit_tokens"] == 12 + 39


# ---------------------------------------------------------------------------
# the allocator (units of tests/test_prefix_cache.py)
# ---------------------------------------------------------------------------

def _states(alloc):
    u = alloc.utilization()
    return u["in_use"], u["cached"], u["free"]


def test_decref_rejects_double_free_and_bad_ids():
    alloc = BlockAllocator(num_blocks=4, block_size=4)
    blk = alloc.allocate()
    alloc.decref([blk])
    with pytest.raises(ValueError):
        alloc.decref([blk])
    with pytest.raises(ValueError):
        alloc.free([blk])
    for bad in (0, -1, 4, 99):
        with pytest.raises(ValueError):
            alloc.decref([bad])
    assert alloc.num_free == 3
    assert alloc.num_in_use == 0


def test_refcount_sharing_and_release_order():
    alloc = BlockAllocator(num_blocks=4, block_size=4)
    blk = alloc.allocate()
    alloc.attach(blk)
    assert alloc.num_in_use == 1 and alloc.cache_hits == 1
    alloc.decref([blk])
    assert alloc.num_in_use == 1
    alloc.decref([blk])
    assert _states(alloc) == (0, 0, 3)


def test_hashed_pages_cache_resurrect_and_lru_evict():
    digest = page_digest(b"", np.arange(4))
    alloc = BlockAllocator(num_blocks=4, block_size=4)
    a = alloc.allocate()
    alloc.register(a, digest)
    alloc.decref([a])
    assert _states(alloc) == (0, 1, 2)
    assert alloc.lookup(digest) == a
    alloc.attach(a)
    assert _states(alloc) == (1, 0, 2) and alloc.cache_hits == 1
    alloc.decref([a])
    d2 = page_digest(digest, np.arange(4) + 9)
    b = alloc.allocate()
    alloc.register(b, d2)
    alloc.decref([b])
    got = [alloc.allocate() for _ in range(3)]
    assert None not in got and alloc.allocate() is None
    assert alloc.cache_evictions == 2
    assert alloc.lookup(digest) is None and alloc.lookup(d2) is None
    u = alloc.utilization()
    assert u["total_allocated"] - u["total_freed"] == u["in_use"] == 3


def test_register_dedup_first_wins():
    digest = page_digest(b"", np.arange(4))
    alloc = BlockAllocator(num_blocks=4, block_size=4)
    a, b = alloc.allocate(), alloc.allocate()
    assert alloc.register(a, digest) and not alloc.register(b, digest)
    assert alloc.lookup(digest) == a
    alloc.decref([b])
    assert _states(alloc) == (1, 0, 2)
    alloc.decref([a])
    assert _states(alloc) == (0, 1, 2)


def test_page_shared_predicate():
    digest = page_digest(b"", np.arange(4))
    alloc = BlockAllocator(num_blocks=4, block_size=4)
    a = alloc.allocate()
    assert not alloc.page_shared(a)
    alloc.attach(a)
    assert alloc.page_shared(a)
    alloc.decref([a])
    alloc.register(a, digest)
    assert alloc.page_shared(a)
    with pytest.raises(ValueError):
        alloc.page_shared(0)


def test_utilization_states_and_byte_accounting():
    alloc = BlockAllocator(9, 4, num_shards=2, page_bytes_per_shard=128)
    a = alloc.allocate()
    alloc.register(a, page_digest(b"", np.arange(4)))
    alloc.decref([a])
    b = alloc.allocate()
    u = alloc.utilization()
    assert u["num_blocks"] == 9 and u["usable_blocks"] == 8
    assert (u["in_use"], u["cached"], u["free"]) == (1, 1, 6)
    assert u["in_use"] + u["cached"] + u["free"] == u["usable_blocks"]
    assert u["utilization"] == 1 / 8
    assert u["pool_bytes_per_shard"] == 9 * 128
    assert u["usable_pool_bytes_per_shard"] == 8 * 128
    assert u["in_use_bytes_per_shard"] == 128
    assert {"cache_hits", "cache_evictions", "cow_copies"} <= set(u)
    alloc.decref([b])


def test_fork_from_prefix_and_cow_swap():
    alloc = BlockAllocator(num_blocks=6, block_size=4)
    digest = page_digest(b"", np.arange(4))
    src = alloc.allocate()
    alloc.register(src, digest)
    alloc.decref([src])
    tab = BlockTable(alloc, max_blocks=3)
    tab.fork_from_prefix([src])
    assert tab.blocks == [src] and tab.shared == 1
    assert alloc.num_in_use == 1 and alloc.cache_hits == 1
    new = alloc.allocate()
    tab.cow(0, new)
    assert tab.blocks == [new] and tab.shared == 0
    assert alloc.cow_copies == 1
    assert alloc.lookup(digest) == src
    assert _states(alloc) == (1, 1, 3)
    tab.release()
    assert _states(alloc) == (0, 1, 4)


def test_swap_store_and_host_cache_accounting():
    """Swap handles park, peek, redeem and discard payloads; the host
    prefix cache is an LRU of ``host_cache_pages`` entries popped on a
    hit; ``host_pages`` counts both tiers."""
    alloc = BlockAllocator(num_blocks=6, block_size=4, host_cache_pages=2)
    h1 = alloc.swap_out(3, "p1")
    h2 = alloc.swap_out(2, "p2")
    assert alloc.host_pages == 5 and alloc.swap_pages(h1) == 3
    assert alloc.swap_in(h1) == (3, "p1")
    alloc.swap_discard(h2)
    assert alloc.host_pages == 0
    u = alloc.utilization()
    assert (u["swapped_out_pages"], u["swapped_in_pages"]) == (5, 3)
    digests = [page_digest(b"", np.arange(4) + i) for i in range(3)]
    for i, d in enumerate(digests):
        alloc.host_put(d, f"page{i}")
    assert alloc.host_pages == 2                # the oldest fell out
    assert alloc.host_lookup(digests[0]) is None
    assert alloc.host_lookup(digests[2]) == "page2"
    assert alloc.host_lookup(digests[2]) is None  # consumed
    u = alloc.utilization()
    assert (u["host_cache_spills"], u["host_cache_hits"]) == (3, 1)


# ---------------------------------------------------------------------------
# the engine's eviction cases (tests/test_prefix_cache.py)
# ---------------------------------------------------------------------------

def _engine(cfg, params, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_blocks_per_seq", 8)
    kw.setdefault("prefill_chunk", 3)
    return PagedServingEngine(cfg, params, device="cpu", **kw)


def test_mid_flight_admission_with_cache_exact(setup):
    """Requests sharing a prefix submitted while others decode stay
    exact."""
    _, _, cfg, params = setup
    rng = np.random.default_rng(23)
    sysp = rng.integers(0, cfg.vocab, 9).astype(np.int32)
    first = [np.concatenate([sysp, rng.integers(0, cfg.vocab, n)
                             .astype(np.int32)]) for n in (4, 6)]
    late = [np.concatenate([sysp, rng.integers(0, cfg.vocab, n)
                            .astype(np.int32)]) for n in (3, 5)]
    eng = _engine(cfg, params, max_blocks_per_seq=10, prefix_cache=True)
    ids = [eng.submit(p, 7) for p in first]
    for _ in range(4):
        eng.step()
    ids += [eng.submit(p, 5) for p in late]
    results = eng.run_to_completion()
    for rid, p, g in zip(ids, first + late, [7, 7, 5, 5]):
        assert results[rid] == _ref(cfg, params, p, g)
    assert eng.metrics()["prefix_cache"]["hit_tokens"] > 0


def test_allocation_pressure_evicts_cached_pages(setup):
    """Cached pages are reclaimable: a later wave that needs the whole
    pool evicts the LRU cache instead of failing, and stays exact."""
    _, _, cfg, params = setup
    rng = np.random.default_rng(25)
    first = rng.integers(0, cfg.vocab, 8).astype(np.int32)
    second = [rng.integers(0, cfg.vocab, 9).astype(np.int32)
              for _ in range(2)]
    eng = _engine(cfg, params, max_blocks_per_seq=4, num_blocks=10,
                  prefill_chunk=4, prefix_cache=True)
    a = eng.submit(first, 4)
    assert eng.run_to_completion()[a] == _ref(cfg, params, first, 4)
    assert eng.alloc.num_cached > 0
    ids = [eng.submit(p, 6) for p in second]
    res = eng.run_to_completion()
    for rid, p in zip(ids, second):
        assert res[rid] == _ref(cfg, params, p, 6)
    assert eng.metrics()["prefix_cache"]["evictions"] > 0
    assert eng.metrics()["oom_finished"] == 0


def test_pool_filling_prompt_warm_reserve_no_livelock(setup):
    """A prompt whose full match alone fills the pool matches page-aligned
    on a warm re-serve and re-prefills its last page: same stream."""
    _, _, cfg, params = setup
    prompt = np.random.default_rng(26).integers(0, cfg.vocab, 8).astype(
        np.int32)
    want = _ref(cfg, params, prompt, 1)
    eng = _engine(cfg, params, max_slots=1, max_blocks_per_seq=2,
                  num_blocks=3, prefill_chunk=4, prefix_cache=True)
    a = eng.submit(prompt, 1)
    assert eng.run_to_completion()[a] == want
    b = eng.submit(prompt.copy(), 1)
    assert eng.run_to_completion(max_steps=50)[b] == want
    assert eng.metrics()["prefix_cache"]["hit_tokens"] == 4
    assert eng.metrics()["oom_finished"] == 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--speculate", "--draft-k", "3"],
    ["--preempt", "swap"],
    ["--prefix-cache", "--host-cache-pages", "6"],
    ["--speculate", "--preempt", "swap", "--tick", "legacy"]])
def test_cli_new_flags_reach_the_engine(argv, capsys):
    """``repro_torch.launch.serve`` takes the JAX CLI's --speculate,
    --draft-k, --preempt and --host-cache-pages and reports them; the
    static batch engine refuses them."""
    from repro_torch.launch.serve import main
    base = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "3"]
    report = main(base + ["--block-size", "4", *argv])
    spec = report["speculative"]
    assert spec["enabled"] == ("--speculate" in argv)
    if "--draft-k" in argv:
        assert spec["draft_k"] == 3
    assert report["preempt"] == ("swap" if "swap" in argv else "recompute")
    assert report["blocks"]["host_cache_capacity_pages"] == \
        (6 if "--host-cache-pages" in argv else 0)
    assert report["output_shape"] == [2]
    assert '"speculative"' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(base + ["--engine", "batch", *argv])
