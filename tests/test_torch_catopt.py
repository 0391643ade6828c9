"""The port's CATopt GA against the JAX package's.

The GA's random numbers cross over through the port's one seam
(``GenDraws``): ``jax_draws`` makes, from a JAX key, exactly the draws
``repro.core.catopt._ga_generation`` makes from it (tournament candidates,
u, u2, uu, the coordinate, and from ``k_op`` both the crossover split and
the operator choice; for the legacy mix the blend weight, the crossover
pick, the shared keys[4] and keys[5] uniforms, the reset values and the
mutation choice).  Under those draws the port's operators, one whole
generation (elitism, batched polish, replacement) and a 3-generation
``optimize_island`` meet the JAX package on the CPU within 1e-5 (one
generation) and 1e-4 (three), fp32.  The problems are small enough that
the tournaments and sorts see no near-ties (checked below), so both
packages pick the same individuals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import catopt as jc
from repro_torch.core import catopt as tc

CPU = torch.device("cpu")
SMALL = dict(pop_size=24, elite=4, polish_k=2, polish_steps=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=None):
    a = np.asarray(a)
    if dtype is not None:
        a = a.astype(dtype)
    return torch.from_numpy(np.array(a))


def jax_draws(key, P, m, cfg):
    """The draws JAX's ``_ga_generation`` makes from ``key``
    (catopt.py:140-175, 204-231), as the port's GenDraws: the mix
    ``cfg.rgenoud_operators`` names.  The legacy mix's keys[4] and keys[5]
    each feed two draws of one shape, so one uniform each stands for both
    (``jax.random.bernoulli(k, p)`` is ``uniform(k) < p`` and
    ``jax.random.normal(k)`` is ``gauss_from(uniform(k))``, checked
    below)."""
    ks = jax.random.split(key, 8)
    k_sel_a, k_sel_b, k_op, k_u1, k_u2, k_u3, k_coord = ks[:7]
    ri = lambda k, shape, lo, hi: _t(  # noqa: E731
        jax.random.randint(k, shape, lo, hi), np.int64)
    cand = dict(cand_a=ri(k_sel_a, (P, cfg.tournament), 0, P),
                cand_b=ri(k_sel_b, (P, cfg.tournament), 0, P))
    if not cfg.rgenoud_operators:
        return tc.GenDraws(
            **cand, alpha=_t(jax.random.uniform(ks[2], (P, 1))),
            pick=_t(jax.random.bernoulli(ks[3], 0.5, (P, m))),
            u4=_t(jax.random.uniform(ks[4], (P, 1))),
            u5=_t(jax.random.uniform(ks[5], (P, m))),
            reset=_t(jax.random.uniform(ks[6], (P, m))),
            which=ri(ks[7], (P, 1), 0, 3))
    return tc.GenDraws(
        **cand,
        u=_t(jax.random.uniform(k_u1, (P, m))),
        u2=_t(jax.random.uniform(k_u2, (P, m))),
        uu=_t(jax.random.uniform(k_u3, (P, 1))),
        coord=ri(k_coord, (P,), 0, m),
        split=ri(k_op, (P, 1), 1, m),
        op=_t(jax.random.categorical(k_op, jnp.log(jnp.array(tc.OP_WEIGHTS)),
                                     shape=(P,)), np.int64))


def problems(seed, E=128, m=32):
    """The JAX problem and the port's copy of it."""
    jp = jc.make_problem(jax.random.PRNGKey(seed), n_events=E, n_dims=m)
    tp = tc.problem_from_numpy(np.asarray(jp.industry_losses),
                               np.asarray(jp.target_recovery), jp.attachment,
                               jp.limit, jp.weight_budget, device=CPU)
    return jp, tp


def jax_arrays(jp):
    return (jp.industry_losses, jp.target_recovery,
            jnp.float32(jp.attachment), jnp.float32(jp.limit),
            jnp.float32(jp.weight_budget))


def min_gap(fit):
    """Smallest gap between two distinct fitness values (ties of exact
    copies are harmless: either pick is the same individual)."""
    v = np.unique(np.asarray(fit))
    return float(np.diff(v).min()) if v.size > 1 else np.inf


def test_problem_from_numpy_round_trip():
    jp, tp = problems(0)
    np.testing.assert_array_equal(tp.industry_losses.numpy(),
                                  np.asarray(jp.industry_losses))
    np.testing.assert_array_equal(tp.target_recovery.numpy(),
                                  np.asarray(jp.target_recovery))
    assert (tp.attachment, tp.limit, tp.weight_budget) == (
        jp.attachment, jp.limit, jp.weight_budget)
    assert (tp.n_events, tp.n_dims) == (128, 32)
    w = np.random.default_rng(0).uniform(size=(5, 32)).astype(np.float32)
    np.testing.assert_allclose(tc.basis_risk(tp, _t(w)).numpy(),
                               np.asarray(jc.basis_risk(jp, jnp.asarray(w))),
                               rtol=1e-5)


def test_make_problem_shape_and_semantics():
    """The port's own problem: the JAX recipe drawn from a torch
    generator (numbers differ, the distribution and contract do not)."""
    p = tc.make_problem(7, n_events=512, n_dims=64, device=CPU)
    q = tc.make_problem(7, n_events=512, n_dims=64, device=CPU)
    jp = jc.make_problem(jax.random.PRNGKey(7), n_events=512, n_dims=64)
    il = p.industry_losses.numpy()
    assert il.shape == (512, 64) and il.dtype == np.float32
    assert torch.equal(p.industry_losses, q.industry_losses)
    assert p.attachment == q.attachment
    frac = (il > 0).mean()
    assert abs(frac - 0.05) < 0.01
    assert abs(frac - (np.asarray(jp.industry_losses) > 0).mean()) < 0.01
    t = p.target_recovery.numpy()
    assert p.attachment > 0 and p.limit > 0 and p.weight_budget > 0
    assert t.min() >= 0 and t.max() <= p.limit * (1 + 1e-6)
    # 80th percentile attachment: about a fifth of events pay out
    assert 0.15 < (t > 0).mean() < 0.25


@pytest.mark.parametrize("gen_frac", [0.0, 0.3, 0.9])
def test_rgenoud_children_match_jax(gen_frac):
    P, m = 24, 32
    cfg = jc.GAConfig()
    key = jax.random.PRNGKey(11)
    pop = jax.random.uniform(jax.random.PRNGKey(12), (P, m))
    fit = jax.random.uniform(jax.random.PRNGKey(13), (P,))
    assert min_gap(fit) > 1e-4
    keys = tuple(jax.random.split(key, 8)[:7])
    want = jc._rgenoud_children(keys, pop, fit, cfg, gen_frac)
    got = tc._rgenoud_children(jax_draws(key, P, m, cfg), _t(pop), _t(fit),
                               tc.GAConfig(), gen_frac)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_draws_replay_reaches_every_operator():
    """The replayed operator choice covers all eight operators, so the
    comparisons above check each of them."""
    d = jax_draws(jax.random.PRNGKey(11), 200, 32, jc.GAConfig())
    assert set(d.op.tolist()) == set(range(8))
    assert d.split.min() >= 1 and d.split.max() < 32


@pytest.mark.parametrize("seed", [0, 1])
def test_one_generation_matches_jax(seed):
    """One whole generation (children, fitness, elitism, the polish of the
    top 2 for 2 steps, replacement) under JAX's draws, within 1e-5."""
    jp, tp = problems(seed)
    cfg_j = jc.GAConfig(**SMALL)
    cfg_t = tc.GAConfig(**SMALL)
    P, m = cfg_j.pop_size, jp.n_dims
    pop = jax.random.uniform(jax.random.PRNGKey(20 + seed), (P, m))
    fit = jc.basis_risk(jp, pop)
    assert min_gap(fit) > 1e-4
    key = jax.random.PRNGKey(30 + seed)
    (want_pop, want_fit), want_best = jc._ga_generation(
        jax_arrays(jp), cfg_j, (pop, fit), key, gen_frac=0.4)
    (got_pop, got_fit), got_best = tc._ga_generation(
        tp.arrays(), cfg_t, (_t(pop), _t(fit)), jax_draws(key, P, m, cfg_t),
        gen_frac=0.4)
    np.testing.assert_allclose(got_pop.numpy(), np.asarray(want_pop),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_fit.numpy(), np.asarray(want_fit),
                               atol=1e-5, rtol=1e-5)
    assert abs(float(got_best) - float(want_best)) <= 1e-5 * float(want_best)


def test_optimize_island_matches_jax_three_generations():
    """E 128, m 32, P 24, 3 generations under JAX's initial population and
    draws: the history and the best w within 1e-4."""
    jp, tp = problems(3)
    kw = dict(SMALL, generations=3)
    cfg_j, cfg_t = jc.GAConfig(**kw), tc.GAConfig(**kw)
    key = jax.random.PRNGKey(4)
    want = jc.optimize_island(jp, cfg_j, key)
    gkeys = jax.random.split(key, cfg_j.generations)
    P, m = cfg_j.pop_size, jp.n_dims
    got = tc.optimize_island(
        tp, cfg_t, pop0=_t(jc._init_pop(key, P, m)),
        draws=lambda g: jax_draws(gkeys[g], P, m, cfg_t), device=CPU)
    np.testing.assert_allclose(got["history"].numpy(),
                               np.asarray(want["history"]), rtol=1e-4)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["pop_fitness"].numpy(),
                               np.asarray(want["pop_fitness"]), rtol=1e-4)
    assert got["history"].shape == (3,)


# --- ports of tests/test_catopt_ops.py, on the port's own generator ----------

def _draws(seed, P, m):
    g = torch.Generator(device=CPU).manual_seed(seed)
    return tc.Draws(g, P, m, tc.GAConfig(), CPU)(0), g


def test_children_respect_box():
    d, g = _draws(2, 16, 8)
    pop = torch.rand((16, 8), generator=g)
    fit = torch.rand((16,), generator=g)
    kids = tc._rgenoud_children(d, pop, fit, tc.GAConfig(), 0.3)
    assert kids.shape == pop.shape
    assert (kids >= 0).all() and (kids <= 1).all()


def test_nonuniform_mutation_decays():
    """Late-generation children stay closer to their parents."""
    pop = torch.full((64, 16), 0.5)
    fit = torch.zeros((64,))
    d, _ = _draws(3, 64, 16)
    early = tc._rgenoud_children(d, pop, fit, tc.GAConfig(), 0.0)
    late = tc._rgenoud_children(d, pop, fit, tc.GAConfig(), 0.98)
    d_early = float((early - pop).abs().mean())
    d_late = float((late - pop).abs().mean())
    assert d_late <= d_early


def test_rgenoud_ga_converges():
    prob = tc.make_problem(3, n_events=128, n_dims=32, device=CPU)
    cfg = tc.GAConfig(pop_size=24, generations=15, elite=4, polish_k=2,
                      polish_steps=2, rgenoud_operators=True)
    res = tc.optimize_island(prob, cfg, seed=4, device=CPU)
    h = res["history"].numpy()
    assert h[-1] < h[0]
    assert (np.diff(h) <= 0).all()          # elitism: the best never rises
    assert float(res["fitness"]) == h[-1]


def test_legacy_operator_mix_not_ported():
    """The legacy operator mix (``rgenoud_operators=False``, once refused
    here) runs: children in the box, the best never rises, the run's
    fitness calls as the default mix's, and its draws carry the legacy
    fields only."""
    prob = tc.make_problem(0, n_events=128, n_dims=16, device=CPU)
    cfg = tc.GAConfig(pop_size=16, generations=6, elite=2, polish_k=1,
                      polish_steps=2, rgenoud_operators=False)
    d = tc.Draws(torch.Generator().manual_seed(1), 16, 16, cfg, CPU)(0)
    assert d.u is None and d.op is None and d.pick.dtype == torch.bool
    assert d.which.min() >= 0 and d.which.max() < 3
    res = tc.optimize_island(prob, cfg, seed=2, device=CPU)
    h = res["history"].numpy()
    assert h.shape == (6,) and (np.diff(h) <= 0).all()
    assert float(res["fitness"]) == h[-1]
    pop = res["pop"]
    assert (pop >= 0).all() and (pop <= 1).all()


def test_legacy_draws_replay_jax_key_sharing():
    """JAX's legacy mix draws two Bernoullis from keys[4] and a Bernoulli
    mask and a normal from keys[5]: ``bernoulli(k, p)`` equals
    ``uniform(k) < p`` exactly, and ``gauss_from(uniform(k))`` equals
    ``normal(k)`` within 1e-5 relative (torch's and XLA's erfinv differ
    by a few ulps in the tails)."""
    k = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(k, (64, 32)))
    for p in (0.5, 0.6, 0.025):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bernoulli(k, p, (64, 32))), u < p)
    np.testing.assert_allclose(tc.gauss_from(_t(u)).numpy(),
                               np.asarray(jax.random.normal(k, (64, 32))),
                               rtol=1e-5, atol=1e-6)
    # the edge: a zero uniform maps to JAX's lowest normal, not -inf
    lo = tc.gauss_from(torch.zeros(1))
    assert torch.isfinite(lo).all() and float(lo) < -5


@pytest.mark.parametrize("seed", [0, 1])
def test_legacy_generation_matches_jax(seed):
    """One legacy-mix generation (crossover, the three mutations,
    fitness, elitism, polish, replacement) under JAX's draws, within
    1e-5; the draws reach every mutation and both crossovers."""
    jp, tp = problems(seed)
    kw = dict(SMALL, rgenoud_operators=False)
    cfg_j, cfg_t = jc.GAConfig(**kw), tc.GAConfig(**kw)
    P, m = cfg_j.pop_size, jp.n_dims
    pop = jax.random.uniform(jax.random.PRNGKey(40 + seed), (P, m))
    fit = jc.basis_risk(jp, pop)
    assert min_gap(fit) > 1e-4
    key = jax.random.PRNGKey(50 + seed)
    d = jax_draws(key, P, m, cfg_t)
    mask = d.u5 < cfg_t.p_mutate / 10
    assert set(d.which[:, 0][mask.any(1)].tolist()) == {0, 1, 2}
    assert (d.u4 < 0.5).any() and ((d.u4 >= 0.5) & (d.u4 < 0.6)).any()
    (want_pop, want_fit), want_best = jc._ga_generation(
        jax_arrays(jp), cfg_j, (pop, fit), key, gen_frac=0.4)
    (got_pop, got_fit), got_best = tc._ga_generation(
        tp.arrays(), cfg_t, (_t(pop), _t(fit)), d, gen_frac=0.4)
    np.testing.assert_allclose(got_pop.numpy(), np.asarray(want_pop),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_fit.numpy(), np.asarray(want_fit),
                               atol=1e-5, rtol=1e-5)
    assert abs(float(got_best) - float(want_best)) <= 1e-5 * float(want_best)


def test_legacy_optimize_island_matches_jax_three_generations():
    """The legacy mix over 3 generations under JAX's initial population
    and draws: the history and the best w within 1e-4."""
    jp, tp = problems(5)
    kw = dict(SMALL, generations=3, rgenoud_operators=False)
    cfg_j, cfg_t = jc.GAConfig(**kw), tc.GAConfig(**kw)
    key = jax.random.PRNGKey(6)
    want = jc.optimize_island(jp, cfg_j, key)
    gkeys = jax.random.split(key, cfg_j.generations)
    P, m = cfg_j.pop_size, jp.n_dims
    got = tc.optimize_island(
        tp, cfg_t, pop0=_t(jc._init_pop(key, P, m)),
        draws=lambda g: jax_draws(gkeys[g], P, m, cfg_t), device=CPU)
    np.testing.assert_allclose(got["history"].numpy(),
                               np.asarray(want["history"]), rtol=1e-4)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["pop_fitness"].numpy(),
                               np.asarray(want["pop_fitness"]), rtol=1e-4)


# --- islands -----------------------------------------------------------------

def test_migrate_ring_semantics():
    """Three islands: island i's k worst slots (by its fitness before the
    exchange) take island i-1's top k, best first into the lowest of
    those slots; everything else is untouched (catopt.py:268-281)."""
    rng = np.random.default_rng(5)
    n, P, m, k = 3, 7, 3, 2
    pops = [_t(rng.uniform(size=(P, m)).astype(np.float32))
            for _ in range(n)]
    fits = [_t(rng.permutation(P).astype(np.float32)) for _ in range(n)]
    new_pops, new_fits = tc._migrate_ring(pops, fits, k)
    for i in range(n):
        src = (i - 1) % n
        best = np.argsort(fits[src].numpy(), kind="stable")[:k]
        worst = np.argsort(fits[i].numpy(), kind="stable")[-k:]
        np.testing.assert_array_equal(new_pops[i][worst].numpy(),
                                      pops[src][best].numpy())
        np.testing.assert_array_equal(new_fits[i][worst].numpy(),
                                      fits[src][best].numpy())
        keep = np.setdiff1d(np.arange(P), worst)
        np.testing.assert_array_equal(new_pops[i][keep].numpy(),
                                      pops[i][keep].numpy())


def test_migrate_ring_single_island_matches_jax():
    """One island sends its top k to itself, as JAX's ppermute over a
    one-device island axis does."""
    from jax.sharding import Mesh, PartitionSpec as P
    rng = np.random.default_rng(6)
    pop = rng.uniform(size=(9, 4)).astype(np.float32)
    fit = rng.permutation(9).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("island",))
    fn = jax.shard_map(lambda p, f: jc._migrate_ring(p, f, 3, "island"),
                       mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                       check_vma=False)
    want_pop, want_fit = fn(jnp.asarray(pop), jnp.asarray(fit))
    got_pops, got_fits = tc._migrate_ring([_t(pop)], [_t(fit)], 3)
    np.testing.assert_array_equal(got_pops[0].numpy(), np.asarray(want_pop))
    np.testing.assert_array_equal(got_fits[0].numpy(), np.asarray(want_fit))


def test_two_islands_on_cpu():
    prob = tc.make_problem(1, n_events=128, n_dims=32, device=CPU)
    cfg = tc.GAConfig(pop_size=16, generations=6, elite=2, polish_k=2,
                      polish_steps=1, migrate_every=3, migrate_k=2)
    res = tc.optimize_islands(prob, cfg, seed=2, devices=[CPU, CPU])
    assert res["n_islands"] == 2
    assert res["history"].shape == (2, 2)
    assert (np.diff(res["history"], axis=1) <= 0).all()
    assert res["w"].shape == (32,)
    w = torch.from_numpy(res["w"])
    assert abs(float(tc.basis_risk(prob, w)) - res["fitness"]) \
        <= 1e-5 * res["fitness"]
    assert tc.island_seed(2, 0) != tc.island_seed(2, 1)


def test_entry_points_default_to_cuda():
    """Without device= the entry points want the GPU: on a machine
    without one they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        p = tc.make_problem(0, n_events=8, n_dims=4)
        assert p.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.make_problem(0, n_events=8, n_dims=4)
    prob = tc.make_problem(0, n_events=8, n_dims=4, device=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.optimize_island(prob, tc.GAConfig(pop_size=4, generations=1))
