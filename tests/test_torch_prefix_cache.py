"""The port's prefix cache (``PagedServingEngine(prefix_cache=True)``) on the
CPU, ported from ``tests/test_prefix_cache.py`` and held to the JAX engine.

The contract under test: with the cache on, every request yields exactly
the tokens of the port's isolated greedy ``generate`` and of the same
engine with the cache off, under shared system prompts, re-served
prompts (a fully cached prompt recomputes its last token into a
copy-on-write page), preemption, token budgets and the two-dispatch tick;
and the hit, eviction and copy-on-write counters equal the JAX engine's
on the same trace and bridged weights.  Output projections are scaled as
in ``test_torch_paged_serving`` so that streams vary.
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
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.launch.serve import generate
from repro_torch.serving import PagedServingEngine
from repro_torch.weights import params_from_numpy

BRANCH_GAIN = 8.0


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


def _engine(cfg, params, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_blocks_per_seq", 8)
    kw.setdefault("prefill_chunk", 3)
    return PagedServingEngine(cfg, params, device="cpu", **kw)


def _ref(cfg, params, prompt, gen):
    out = generate(cfg, params, torch.from_numpy(prompt)[None], gen)
    return out[0, len(prompt):].tolist()


def _shared(seed, cfg, n_sys, tails):
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, cfg.vocab, n_sys).astype(np.int32)
    return sysp, [np.concatenate([sysp, rng.integers(0, cfg.vocab, n)
                                  .astype(np.int32)]) for n in tails]


def _waves(eng, prompts, gens, n=2):
    out = []
    for _ in range(n):
        ids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
        res = eng.run_to_completion()
        out.append([res[i] for i in ids])
        eng.clear_finished()
    return out


def test_streams_and_counters_match_generate_and_jax(setup):
    """Two waves of shared-system-prompt requests plus a repeated prompt:
    streams equal the port's generate and the JAX engine's, and the
    prefix_cache counters (hits, lookups, page hits, evictions, COW
    copies, cached pages) equal the JAX engine's."""
    jcfg, jparams, cfg, params = setup
    _, prompts = _shared(30, cfg, 9, (3, 6, 2))
    prompts.append(prompts[0].copy())
    gens = [5, 4, 6, 3]
    kw = dict(max_slots=2, block_size=4, max_blocks_per_seq=8,
              prefill_chunk=3, num_blocks=13, prefix_cache=True)
    jeng = JaxPagedServingEngine(jcfg, jparams, **kw)
    teng = _engine(cfg, params, **kw)
    jout, tout = _waves(jeng, prompts, gens), _waves(teng, prompts, gens)
    refs = [_ref(cfg, params, p, g) for p, g in zip(prompts, gens)]
    assert tout == jout == [refs, refs]
    jm, tm = jeng.metrics(), teng.metrics()
    assert tm["prefix_cache"] == jm["prefix_cache"]
    assert tm["prefix_cache"]["page_hits"] > 0
    assert tm["prefix_cache"]["cow_copies"] > 0
    assert tm["blocks"] == jm["blocks"]
    assert set(tm) == set(jm)


def test_shared_system_prompt_exact_and_hit_rate(setup):
    """A shared system prompt re-served across two waves: streams match
    prefix_cache=False and isolated generate byte for byte; wave 2 rides
    the cache for the shared pages."""
    _, _, cfg, params = setup
    sysp, prompts = _shared(20, cfg, 10, (3, 5, 2, 4))   # 2.5 pages
    gens = [5, 4, 6, 3]
    refs = [_ref(cfg, params, p, g) for p, g in zip(prompts, gens)]
    cold = _waves(_engine(cfg, params, num_blocks=41), prompts, gens)
    eng = _engine(cfg, params, prefix_cache=True, num_blocks=41)
    warm = _waves(eng, prompts, gens)
    assert warm == cold == [refs, refs]
    m = eng.metrics()["prefix_cache"]
    assert m["enabled"]
    assert m["hit_tokens"] >= 4 * (sysp.size // 4) * 4
    assert m["hit_rate"] > 0.3 and m["page_hits"] > 0
    assert m["cached_pages"] > 0


@pytest.mark.parametrize("unified", [True, False],
                         ids=["unified", "legacy"])
def test_fully_cached_prompt_cow_on_partial_page(setup, unified):
    """An aligned prompt re-served after completion matches every page;
    the engine recomputes its last token into a copy of the tail page
    (the cached page itself is never written) and the stream is
    unchanged; a third serve hits again."""
    _, _, cfg, params = setup
    prompt = np.random.default_rng(21).integers(0, cfg.vocab, 12).astype(
        np.int32)                                          # 3 full pages
    ref = _ref(cfg, params, prompt, 4)
    eng = _engine(cfg, params, prefix_cache=True, unified=unified)
    a = eng.submit(prompt, 4)
    assert eng.run_to_completion()[a] == ref
    b = eng.submit(prompt.copy(), 4)
    assert eng.run_to_completion()[b] == ref
    m = eng.metrics()["prefix_cache"]
    assert m["cow_copies"] >= 1, "shared tail page was not copied"
    assert m["hit_tokens"] == prompt.size - 1
    c = eng.submit(prompt.copy(), 4)
    assert eng.run_to_completion()[c] == ref


@pytest.mark.parametrize("policy", ["longest", "newest"])
def test_prefix_cache_under_preemption_exact(setup, policy):
    """A pool tight enough to preempt: re-admission may re-attach the
    victim's own cached pages; streams stay exact and every page ends
    cached or free."""
    _, _, cfg, params = setup
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (6, 7)]
    gens = [9, 8]
    eng = _engine(cfg, params, max_blocks_per_seq=6, num_blocks=8,
                  prefill_chunk=4, prefix_cache=True,
                  preemption_policy=policy)
    ids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    results = eng.run_to_completion()
    assert eng.metrics()["scheduler"]["preemptions"] >= 1
    for rid, p, g in zip(ids, prompts, gens):
        assert results[rid] == _ref(cfg, params, p, g)
    util = eng.alloc.utilization()
    assert util["in_use"] == 0
    assert util["cached"] + util["free"] == util["usable_blocks"]


def test_unified_legacy_and_budget_ticks_identical_with_cache(setup):
    """The cache is tick-agnostic: the unified, token-budget-throttled and
    two-dispatch engines emit identical streams with it on, equal to
    generate's."""
    _, _, cfg, params = setup
    _, prompts = _shared(24, cfg, 8, (5, 2, 7))
    gens = [4, 6, 3]
    outs = []
    for kw in (dict(), dict(token_budget=5), dict(unified=False)):
        eng = _engine(cfg, params, max_blocks_per_seq=10, prefix_cache=True,
                      **kw)
        outs.append(_waves(eng, prompts, gens))
        assert eng.metrics()["prefix_cache"]["hit_tokens"] > 0
    assert outs[0] == outs[1] == outs[2]
    for toks, p, g in zip(outs[0][0], prompts, gens):
        assert toks == _ref(cfg, params, p, g)


def test_int8_pages_cow_carries_scales(setup):
    """With int8 pages the COW step copies the scale pools too: the
    streams of a re-served aligned prompt with the cache on (attached
    pages, last token recomputed into a copied page) equal those with it
    off."""
    _, _, cfg, params = setup
    prompt = np.random.default_rng(23).integers(0, cfg.vocab, 8).astype(
        np.int32)                                          # 2 full pages
    gens = [5, 5, 5]
    outs = []
    for pc in (False, True):
        eng = _engine(cfg, params, kv_dtype="int8", prefix_cache=pc)
        served = []
        for g in gens:
            rid = eng.submit(prompt.copy(), g)
            served.append(eng.run_to_completion()[rid])
        outs.append(served)
    assert outs[0] == outs[1]
    m = eng.metrics()["prefix_cache"]
    assert m["cow_copies"] >= 1 and m["hit_tokens"] > 0


def test_copy_page_runs_through_the_op_on_every_pool(setup, monkeypatch):
    """The engine's COW goes through ``ops.copy_pages`` once per COW, over
    every pool of the cache dict in its order: K and V, plus both scale
    pools with int8 pages (one launch a COW on the card)."""
    _, _, cfg, params = setup
    calls = []
    real = pa_kernel.copy_pages

    def spy(pools, src, dst=None):
        calls.append([p.data_ptr() for p in pools])
        return real(pools, src, dst)

    monkeypatch.setattr(pa_kernel, "copy_pages", spy)
    prompt = np.arange(8, dtype=np.int32) + 3
    for kv, n_pools in ((None, 2), ("int8", 4)):
        calls.clear()
        eng = _engine(cfg, params, prefix_cache=True, kv_dtype=kv)
        for _ in range(2):                 # the second serve hits in full
            eng.submit(prompt.copy(), 3)
            eng.run_to_completion()
        cow = eng.metrics()["prefix_cache"]["cow_copies"]
        order = [p.data_ptr() for p in eng.cache.values()]
        assert len(order) == n_pools
        assert cow >= 1 and calls == [order] * cow
