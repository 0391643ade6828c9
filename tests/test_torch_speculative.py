"""The port's speculative decoding (``PagedServingEngine(speculate=True)``) on
the CPU, ported from ``tests/test_speculative.py`` and held to the JAX
engine.

The contract under test: with speculation on, every request yields
exactly the tokens of the port's isolated greedy ``generate`` and of the
JAX engine, on both ticks, with the prefix cache on and off, under an
always-wrong drafter (full rollback) and under preemption mid-speculation;
a rejected draft never becomes a cached page; and the drafted and accepted
totals equal the JAX engine's on the same prompts and bridged weights.
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
from repro.serving import NGramDrafter as JaxNGramDrafter
from repro.serving import PagedServingEngine as JaxPagedServingEngine
from repro_torch.config import get_config, reduced
from repro_torch.launch.serve import generate
from repro_torch.serving import NGramDrafter, PagedServingEngine
from repro_torch.serving.blocks import page_digest
from repro_torch.serving.scheduler import FCFSScheduler
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


def _engine(cfg, params, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_blocks_per_seq", 12)
    kw.setdefault("prefill_chunk", 3)
    return PagedServingEngine(cfg, params, device="cpu", **kw)


def _ref(cfg, params, prompt, gen):
    out = generate(cfg, params, torch.from_numpy(prompt)[None], gen)
    return out[0, len(prompt):].tolist()


def _serve(eng, prompts, gens):
    ids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    res = eng.run_to_completion()
    return [res[i] for i in ids]


def _workload(cfg, rng):
    """Repetitive and random prompts: the first make the drafter propose
    (and the model accept), the second keep the no-proposal path busy."""
    pat = rng.integers(0, cfg.vocab, size=3).astype(np.int32)
    prompts = [np.tile(pat, 4).astype(np.int32),
               rng.integers(0, cfg.vocab, size=8).astype(np.int32),
               np.tile(pat, 2).astype(np.int32),
               rng.integers(0, cfg.vocab, size=5).astype(np.int32)]
    return prompts, [12, 5, 10, 6]


# ---------------------------------------------------------------------------
# the drafter and the scheduler's draft grants (model-free)
# ---------------------------------------------------------------------------

def test_ngram_drafter_prompt_lookup():
    """The drafter copies the continuation of the tail n-gram's previous
    occurrence, longest gram first, exactly k tokens when matched."""
    d = NGramDrafter()
    d.reset([5, 6, 7, 5, 6])
    assert d.draft(3) == [7, 5, 6]
    assert d.draft(2) == [7, 5]
    assert d.draft(0) == []
    d.reset([1, 2, 3, 4])
    assert d.draft(4) == []
    d.reset([9, 1, 2, 8, 3, 1, 2])          # trigram miss, bigram "1 2"
    assert d.draft(2) == [8, 3]
    d2 = NGramDrafter()
    d2.reset([9, 1, 2, 8])
    for t in (3, 1, 2):
        d2.append(t)
    assert d2.draft(2) == [8, 3] and len(d2) == 7


def test_ngram_drafter_periodic_continuation():
    """The copy window wraps around the match period."""
    d = NGramDrafter()
    d.reset([3, 3])
    assert d.draft(4) == [3, 3, 3, 3]
    d.reset([7, 4, 7, 4])
    assert d.draft(5) == [7, 4, 7, 4, 7]


def test_ngram_drafter_matches_jax_drafter():
    """On random low-entropy streams, grown token by token, the port's
    drafter proposes what the JAX package's does at every length."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        stream = rng.integers(0, 4, size=40)
        ours, theirs = NGramDrafter(), JaxNGramDrafter()
        for t in stream:
            ours.append(int(t))
            theirs.append(int(t))
            for k in (1, 3, 6):
                assert ours.draft(k) == theirs.draft(k)


def test_plan_tick_draft_grants():
    """Draft tokens are budgeted after prefill chunks in first-admission
    order; ``draft=None`` keeps the single-value return."""
    sched = FCFSScheduler()

    class R:
        def __init__(self, rid):
            self.req_id = rid

    for rid in (0, 1, 2):
        sched.submit(R(rid), prompt_tokens=4)
        sched.next_request()
        sched.on_admit(rid)
    prefill = [(5, 2, 10)]
    draft = [(0, 0, 3), (1, 1, 4)]
    assert sched.plan_tick(None, [0, 1], prefill, chunk=4, draft=draft) \
        == ({5: 4}, {0: 3, 1: 4})
    assert sched.plan_tick(9, [0, 1], prefill, chunk=4, draft=draft) \
        == ({5: 4}, {0: 3})
    assert sched.plan_tick(6, [0, 1], prefill, chunk=4, draft=draft) \
        == ({5: 4}, {})
    assert sched.plan_tick(2, [0, 1], prefill, chunk=4, draft=draft) \
        == ({}, {})
    assert sched.plan_tick(6, [0, 1], prefill, chunk=4) == {5: 4}


@pytest.mark.parametrize("kw", [dict(draft_k=0), dict(draft_k=-2),
                                dict(swap_pages_per_tick=0),
                                dict(preempt="drop")])
def test_draft_k_validation(setup, kw):
    """``draft_k`` (and the swap knobs) are checked as the JAX engine
    checks them."""
    _, _, cfg, params = setup
    with pytest.raises(ValueError):
        _engine(cfg, params, speculate=True, **kw)


# ---------------------------------------------------------------------------
# the engine: streams, accept and rollback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("unified", [True, False], ids=["unified", "legacy"])
@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["cache_off", "cache_on"])
def test_stream_identity_vs_greedy_and_jax(setup, unified, prefix_cache):
    """speculate=True serves exactly the port's greedy streams and the
    JAX engine's, on both ticks, with the prefix cache on and off; it
    drafts, and its drafted and accepted totals, dispatches and metrics
    keys equal the JAX engine's."""
    jcfg, jparams, cfg, params = setup
    prompts, gens = _workload(cfg, np.random.default_rng(0))
    prompts += [prompts[0].copy()]            # a re-served prompt
    gens += [9]
    refs = [_ref(cfg, params, p, g) for p, g in zip(prompts, gens)]
    kw = dict(max_slots=2, block_size=4, max_blocks_per_seq=12,
              prefill_chunk=3, unified=unified, prefix_cache=prefix_cache,
              speculate=True, draft_k=4)
    jeng = JaxPagedServingEngine(jcfg, jparams, **kw)
    teng = _engine(cfg, params, **kw)
    assert _serve(teng, prompts, gens) == _serve(jeng, prompts, gens) == refs
    tm, jm = teng.metrics(), jeng.metrics()
    assert tm["speculative"] == jm["speculative"]
    assert tm["speculative"]["drafted_tokens"] > 0
    assert tm["speculative"]["accepted_tokens"] > 0
    assert teng.dispatches == jeng.dispatches
    assert tm["prefix_cache"] == jm["prefix_cache"]
    assert set(tm) == set(jm)
    # the scheduler counts accepted tokens only
    assert tm["scheduler"]["generated_tokens"] == sum(gens)


def test_token_budget_throttles_drafts_like_jax(setup):
    """Under a token budget drafts get what the prefill chunks leave: the
    same streams, and the same drafted totals, as the JAX engine."""
    jcfg, jparams, cfg, params = setup
    prompts, gens = _workload(cfg, np.random.default_rng(7))
    kw = dict(max_slots=3, block_size=4, max_blocks_per_seq=12,
              prefill_chunk=4, token_budget=6, speculate=True, draft_k=3)
    jeng = JaxPagedServingEngine(jcfg, jparams, **kw)
    teng = _engine(cfg, params, **kw)
    refs = [_ref(cfg, params, p, g) for p, g in zip(prompts, gens)]
    assert _serve(teng, prompts, gens) == _serve(jeng, prompts, gens) == refs
    assert teng.metrics()["speculative"] == jeng.metrics()["speculative"]


class _WrongDrafter(NGramDrafter):
    """Always proposes (wrong) tokens: exactness must not depend on the
    drafter, only the tick count may."""

    def draft(self, k):
        if k <= 0 or not self.tokens:
            return []
        return [(self.tokens[-1] + 1 + i) % 64 for i in range(k)]


def _inject_wrong_drafter(eng):
    orig = eng._make_drafter

    def _make(slot):
        orig(slot)
        eng.slot_drafter[slot].__class__ = _WrongDrafter

    eng._make_drafter = _make


@pytest.mark.parametrize("unified", [True, False], ids=["unified", "legacy"])
def test_rollback_exact_under_full_rejection(setup, unified):
    """An always-wrong drafter forces the full rollback on every verify:
    streams stay exact and nothing is accepted."""
    _, _, cfg, params = setup
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 8, 6)]
    gens = [7, 5, 8]
    eng = _engine(cfg, params, unified=unified, speculate=True, draft_k=4)
    _inject_wrong_drafter(eng)
    assert _serve(eng, prompts, gens) == [
        _ref(cfg, params, p, g) for p, g in zip(prompts, gens)]
    m = eng.metrics()["speculative"]
    assert m["drafted_tokens"] > 0 and m["accepted_tokens"] == 0


def test_rejected_draft_never_cached(setup):
    """Every page digest the allocator indexes lies on an accepted stream:
    a rejected draft token never becomes a page another prompt attaches."""
    _, _, cfg, params = setup
    prompts, gens = _workload(cfg, np.random.default_rng(2))
    eng = _engine(cfg, params, prefix_cache=True, speculate=True, draft_k=4)
    _inject_wrong_drafter(eng)
    ids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    results = eng.run_to_completion()
    assert eng.metrics()["speculative"]["drafted_tokens"] > 0
    bs = eng.block_size
    allowed = set()
    for rid, p in zip(ids, prompts):
        stream = np.concatenate([p, np.asarray(results[rid], np.int32)])
        parent = b""
        for k in range(len(stream) // bs):
            parent = page_digest(parent, stream[k * bs:(k + 1) * bs])
            allowed.add(parent)
    indexed = set(eng.alloc._hash_index.keys())
    assert indexed, "the prefix cache registered nothing"
    assert indexed <= allowed, "a digest covers rejected draft tokens"


@pytest.mark.parametrize("policy", ["longest", "newest"])
@pytest.mark.parametrize("preempt", ["recompute", "swap"])
def test_mid_speculation_preemption_exact(setup, policy, preempt):
    """A pool too small for both requests preempts mid-speculation; the
    resumed streams (drafter rebuilt from accepted tokens) stay exact and
    equal the JAX engine's, with the same preemptions and drafts."""
    jcfg, jparams, cfg, params = setup
    rng = np.random.default_rng(4)
    pat = rng.integers(0, cfg.vocab, size=3).astype(np.int32)
    prompts = [np.tile(pat, 3).astype(np.int32),
               np.tile(pat, 2).astype(np.int32)]
    gens = [20, 18]
    kw = dict(max_slots=2, block_size=4, max_blocks_per_seq=8, num_blocks=9,
              prefill_chunk=4, preemption_policy=policy, preempt=preempt,
              speculate=True, draft_k=4)
    jeng = JaxPagedServingEngine(jcfg, jparams, **kw)
    teng = _engine(cfg, params, **kw)
    refs = [_ref(cfg, params, p, g) for p, g in zip(prompts, gens)]
    assert _serve(teng, prompts, gens) == _serve(jeng, prompts, gens) == refs
    tm, jm = teng.metrics(), jeng.metrics()
    assert tm["scheduler"]["preemptions"] >= 1
    assert tm["scheduler"]["preemptions"] == jm["scheduler"]["preemptions"]
    assert tm["speculative"] == jm["speculative"]
    assert tm["blocks"] == jm["blocks"]


def test_speculate_off_is_bytewise_default(setup):
    """speculate=False (the default) keeps a scalar token per request per
    tick and the disabled speculative report."""
    _, _, cfg, params = setup
    p = np.random.default_rng(5).integers(0, cfg.vocab, 5).astype(np.int32)
    eng = _engine(cfg, params, max_slots=1, max_blocks_per_seq=8,
                  prefill_chunk=4)
    eng.submit(p, 3)
    seen = []
    while len(seen) < 3:
        for v in eng.step().values():
            assert isinstance(v, int)
            seen.append(v)
    assert seen == _ref(cfg, params, p, 3)
    assert eng.metrics()["speculative"] == {
        "enabled": False, "draft_k": 4, "drafted_tokens": 0,
        "accepted_tokens": 0, "accept_rate": 0.0}


def test_telemetry_spec_fields(setup, tmp_path):
    """Per-tick drafted/accepted, the counters and the accept-length
    histogram agree with the totals, and the dumped trace passes the
    offline validator."""
    _, _, cfg, params = setup
    prompts, gens = _workload(cfg, np.random.default_rng(6))
    eng = _engine(cfg, params, speculate=True, draft_k=4)
    results = _serve(eng, prompts, gens)
    ticks = eng.telemetry.ticks.items()
    drafted = sum(t["drafted"] for t in ticks)
    accepted = sum(t["accepted"] for t in ticks)
    assert drafted > 0
    assert all(0 <= t["accepted"] <= t["drafted"] for t in ticks)
    for t in ticks:
        if t["prefill_tokens"] == 0 and t["decode_tokens"]:
            assert t["emitted"] == \
                t["decode_tokens"] - t["drafted"] + t["accepted"]
    m = eng.metrics()
    assert m["speculative"]["drafted_tokens"] == drafted
    assert m["speculative"]["accepted_tokens"] == accepted
    snap = eng.telemetry.registry.snapshot()
    assert snap["spec.drafted"] == drafted
    assert snap["spec.accepted"] == accepted
    assert snap["spec_accept_len"]["count"] > 0
    assert sum(t["emitted"] for t in ticks) == sum(len(v) for v in results)
    from tools.tracestats import check, load, summarize
    path = tmp_path / "spec.jsonl"
    eng.dump_trace(path)
    meta, ticks2, spans, _ = load(str(path))
    summary = summarize(meta, ticks2, spans)
    assert summary["drafted"] == drafted and summary["accepted"] == accepted
    assert check(meta, ticks2, spans, summary) == []


def test_verify_chain_shapes_reach_the_attention_op(setup, monkeypatch):
    """The ticks hand the fused update verify chains: the two-dispatch
    tick passes ``S`` = the bucketed chain width, capped at ``draft_k +
    1`` = 5; the unified tick a ``row_map`` view whose width is a 5-row
    chain's power of two, 8."""
    from repro_torch.kernels.paged_attention import ops
    _, _, cfg, params = setup
    prompts, gens = _workload(cfg, np.random.default_rng(0))
    for unified in (True, False):
        seen = []
        real = ops.paged_attention_update

        def spy(q, *a, **k):
            seen.append(q.shape[1])
            return real(q, *a, **k)

        monkeypatch.setattr(ops, "paged_attention_update", spy)
        eng = _engine(cfg, params, unified=unified, speculate=True,
                      draft_k=4, prefill_chunk=2)
        _serve(eng, prompts, gens)
        monkeypatch.undo()
        assert max(seen) == (8 if unified else 5), (unified, seen)
