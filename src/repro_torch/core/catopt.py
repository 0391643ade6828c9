"""CATopt: catastrophe-bond basis-risk minimisation, the paper's flagship
workload, in PyTorch.  The counterpart of ``repro/core/catopt.py``.

Problem (paper §4): a cat bond with a parametric trigger pays
    Recovery_i(w) = min(max(sum_j w_j * IL_{i,j} - Att, 0), Limit)
for event i, where IL are industry losses by region-peril and w are the
sponsor's market-share weights.  The sponsor wants weights minimising
*basis risk*, the mismatch between the parametric recovery and the recovery
its actual losses warranted.

Solver: an island genetic algorithm in the style of rgenoud with eight
operators, elitism, and a gradient polish of the best individuals (a
momentum step batched over the ``polish_k`` elites: one ``(k, m)`` fitness
call per step, which is what JAX's ``vmap(polish)`` computes).  Fitness
runs through ``repro_torch.kernels.recovery.ops.basis_risk``: the CUDA
kernel on the card, its plain version on the CPU.

Randomness goes through one seam: :class:`Draws` returns one generation's
random numbers (:class:`GenDraws`) from an explicit ``torch.Generator`` on
the island's device.  ``optimize_island(draws=...)`` takes any callable of
the generation index in its place, so a test can feed the draws the JAX
package makes from its keys.  A Python loop over generations takes the
place of ``lax.scan``; islands are one generator and one device each, and
ring migration copies the top k with ``.to(next_device)`` in this one
process (no ``torch.distributed``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, cuda_devices, resolve_device
from repro_torch.kernels.recovery import ops as recovery_ops

# rgenoud-ish default weights of the eight operators
OP_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 1.5, 1.5, 1.0, 1.5)


# ---------------------------------------------------------------------------
# Problem
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CatBondProblem:
    industry_losses: torch.Tensor  # (E, m) float32
    target_recovery: torch.Tensor  # (E,) recovery the actual losses warranted
    attachment: float
    limit: float
    weight_budget: float           # sum(w) <= budget (market-share constraint)

    @property
    def n_events(self) -> int:
        return self.industry_losses.shape[0]

    @property
    def n_dims(self) -> int:
        return self.industry_losses.shape[1]

    @property
    def device(self) -> torch.device:
        return self.industry_losses.device

    def to(self, device) -> "CatBondProblem":
        return dataclasses.replace(
            self, industry_losses=self.industry_losses.to(device),
            target_recovery=self.target_recovery.to(device))

    def arrays(self) -> Tuple:
        """(il, target, att, limit, budget), as ``_ga_generation`` takes."""
        return (self.industry_losses, self.target_recovery, self.attachment,
                self.limit, self.weight_budget)


def make_problem(seed: int = 0, n_events: int = 8192, n_dims: int = 2048,
                 sparsity: float = 0.05, noise: float = 0.05,
                 device: DeviceLike = None) -> CatBondProblem:
    """Synthetic but realistically shaped CATopt instance, drawn on
    ``device`` (``cuda`` unless given) from a generator seeded with
    ``seed``.

    Industry losses: lognormal severities on a sparse event footprint
    (events hit about ``sparsity`` of the region-perils).  Actual sponsor
    losses follow a hidden true weight vector plus idiosyncratic noise, so
    a good w exists but is not exactly recoverable.  As in the JAX package,
    where one key draws both the mask and the values of the true weights,
    a kept weight is a uniform below 0.3.
    """
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (n_events, n_dims)
    footprint = torch.rand(shape, generator=g, device=dev) < sparsity
    severity = torch.exp(torch.randn(shape, generator=g, device=dev) * 1.5)
    il = torch.where(footprint, severity, 0.0)
    del footprint, severity
    u = torch.rand(n_dims, generator=g, device=dev)
    w_true = torch.where(u < 0.3, u, 0.0)
    actual = il @ w_true
    actual = actual * (1 + noise * torch.randn(n_events, generator=g,
                                               device=dev))
    att = float(torch.quantile(actual, 0.80))
    limit = float(torch.quantile(actual, 0.99) - att)
    target = torch.clamp(actual - att, 0.0, limit)
    return CatBondProblem(industry_losses=il, target_recovery=target,
                          attachment=att, limit=limit,
                          weight_budget=float(w_true.sum()) * 1.5)


def problem_from_numpy(industry_losses, target_recovery, attachment: float,
                       limit: float, weight_budget: float,
                       device: DeviceLike = None) -> CatBondProblem:
    """A problem from host arrays (a JAX problem's, through
    ``np.asarray``), on ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return CatBondProblem(industry_losses=t(industry_losses),
                          target_recovery=t(target_recovery),
                          attachment=float(attachment), limit=float(limit),
                          weight_budget=float(weight_budget))


# ---------------------------------------------------------------------------
# Objective
# ---------------------------------------------------------------------------

def recovery(problem: CatBondProblem, w: torch.Tensor) -> torch.Tensor:
    """w: (..., m) -> (..., E) parametric recovery per event."""
    return recovery_ops.recovery(problem.industry_losses, w,
                                 problem.attachment, problem.limit)


def basis_risk(problem: CatBondProblem, w: torch.Tensor) -> torch.Tensor:
    """RMSE basis risk + constraint penalties.  w: (..., m) -> (...)."""
    return recovery_ops.basis_risk(
        problem.industry_losses, problem.target_recovery, w,
        problem.attachment, problem.limit, problem.weight_budget)


# ---------------------------------------------------------------------------
# GA state, draws & operators (rgenoud-style)
# ---------------------------------------------------------------------------

@dataclass
class GAConfig:
    pop_size: int = 200           # paper: population 200
    generations: int = 50         # paper: 50 generations
    elite: int = 8
    tournament: int = 4
    p_crossover: float = 0.6
    p_mutate: float = 0.25
    polish_k: int = 4             # elites polished with gradients
    polish_steps: int = 5
    polish_lr: float = 0.02
    migrate_every: int = 5
    migrate_k: int = 4            # individuals migrating per ring step
    rgenoud_operators: bool = True  # use rgenoud's 8-operator mix
    nonuniform_b: float = 3.0     # rgenoud's B (mutation decay shape)


@dataclass
class GenDraws:
    """One generation's random numbers, all on the island's device."""
    cand_a: torch.Tensor   # (P, tournament) int64: parent-a tournaments
    cand_b: torch.Tensor   # (P, tournament) int64: parent-b tournaments
    u: torch.Tensor        # (P, m) uniform [0, 1)
    u2: torch.Tensor       # (P, m) uniform [0, 1)
    uu: torch.Tensor       # (P, 1) uniform [0, 1)
    coord: torch.Tensor    # (P,) int64 in [0, m): mutated coordinate
    split: torch.Tensor    # (P, 1) int64 in [1, m): single-point crossover
    op: torch.Tensor       # (P,) int64 in [0, 8): operator, by OP_WEIGHTS


class Draws:
    """The seam for a GA's randomness: ``draws(g)`` returns generation
    g's :class:`GenDraws` from ``generator``, in call order (g itself is
    not used: a replay can index by it).  Nothing here waits for the
    device."""

    def __init__(self, generator: torch.Generator, pop_size: int, m: int,
                 cfg: GAConfig, device: torch.device):
        self.gen, self.P, self.m, self.cfg = generator, pop_size, m, cfg
        self.device = device
        w = torch.tensor(OP_WEIGHTS, dtype=torch.float64)
        self.cdf = (torch.cumsum(w, 0) / w.sum())[:-1].float().to(device)

    def __call__(self, g: int) -> GenDraws:
        P, m, k, dev, gen = self.P, self.m, self.cfg.tournament, \
            self.device, self.gen

        def uniform(*shape):
            return torch.rand(shape, generator=gen, device=dev)

        def randint(lo, hi, *shape):
            return torch.randint(lo, hi, shape, generator=gen, device=dev)

        return GenDraws(cand_a=randint(0, P, P, k), cand_b=randint(0, P, P, k),
                        u=uniform(P, m), u2=uniform(P, m), uu=uniform(P, 1),
                        coord=randint(0, m, P), split=randint(1, m, P, 1),
                        op=torch.searchsorted(self.cdf, uniform(P),
                                              right=True))


def _init_pop(generator: torch.Generator, pop: int, m: int,
              device: torch.device) -> torch.Tensor:
    return torch.rand((pop, m), generator=generator, device=device)


def _tournament_select(cand: torch.Tensor,
                       fitness: torch.Tensor) -> torch.Tensor:
    """Lower fitness is better.  cand (n, k) -> n winner indices (the
    first of equal candidates, as ``jnp.argmin``)."""
    best = torch.argmin(fitness[cand], dim=1, keepdim=True)
    return torch.gather(cand, 1, best)[:, 0]


def _rgenoud_children(draws: GenDraws, pop: torch.Tensor,
                      fitness: torch.Tensor, cfg: GAConfig,
                      gen_frac: float) -> torch.Tensor:
    """pop: (P, m) in [0,1].  gen_frac: g/G in [0,1] (non-uniform decay).

    Returns (P, m) children, each made by one of rgenoud's operators 1-8
    (operator 9, local-minimum crossover, is the gradient polish)."""
    P_, m = pop.shape
    pa_idx = _tournament_select(draws.cand_a, fitness)
    pb_idx = _tournament_select(draws.cand_b, fitness)
    pa, pb = pop[pa_idx], pop[pb_idx]
    fa, fb = fitness[pa_idx], fitness[pb_idx]
    u, u2, uu = draws.u, draws.u2, draws.uu
    coord = torch.nn.functional.one_hot(draws.coord, m).to(pop.dtype)

    # 1 cloning
    c1 = pa
    # 2 uniform mutation (one coordinate -> uniform)
    c2 = pa * (1 - coord) + coord * u
    # 3 boundary mutation (one coordinate -> 0 or 1)
    c3 = pa * (1 - coord) + coord * torch.round(u)
    # 4 non-uniform mutation (one coordinate, decaying step)
    decay = (1.0 - gen_frac) ** cfg.nonuniform_b
    step = 1.0 - u ** decay
    up = torch.where(u2 < 0.5, pa + (1 - pa) * step, pa - pa * step)
    c4 = pa * (1 - coord) + coord * up
    # 5 polytope crossover (convex combination of two parents)
    c5 = uu * pa + (1 - uu) * pb
    # 6 simple (single-point) crossover
    left = torch.arange(m, device=pop.device)[None, :] < draws.split
    c6 = torch.where(left, pa, pb)
    # 7 whole non-uniform mutation (all coordinates)
    c7 = up
    # 8 heuristic crossover: child = better + u*(better - worse)
    a_better = (fa < fb)[:, None]
    better = torch.where(a_better, pa, pb)
    worse = torch.where(a_better, pb, pa)
    c8 = better + uu * (better - worse)

    ops = torch.stack([c1, c2, c3, c4, c5, c6, c7, c8])   # (8, P, m)
    children = ops[draws.op, torch.arange(P_, device=pop.device)]
    return torch.clamp(children, 0.0, 1.0)


def _polish(arrays, cfg: GAConfig, w: torch.Tensor) -> torch.Tensor:
    """``cfg.polish_steps`` momentum steps on each row of w (k, m) at once:
    ``mom = 0.9 mom + 0.1 g``, ``w = clip(w - lr mom, 0, 1)``.  The rows'
    gradients are independent, so the gradient of the summed fitness is
    each row's own."""
    il, target, att, limit, budget = arrays
    mom = torch.zeros_like(w)
    for _ in range(cfg.polish_steps):
        with torch.enable_grad():
            w_ = w.detach().requires_grad_(True)
            obj = recovery_ops.basis_risk(il, target, w_, att, limit,
                                          budget).sum()
            g, = torch.autograd.grad(obj, w_)
        mom = 0.9 * mom + 0.1 * g
        w = torch.clamp(w - cfg.polish_lr * mom, 0.0, 1.0)
    return w


def _ga_generation(arrays, cfg: GAConfig, carry, draws: GenDraws,
                   gen_frac: float = 0.5):
    """One generation on one island.  carry = (pop (P,m), fitness (P,)).

    Returns ((new_pop, new_fit), best fitness) as JAX's ``lax.scan`` body.
    Fitness calls: one for the children, ``polish_steps`` inside the
    polish's gradients and one for the polished rows."""
    if not cfg.rgenoud_operators:
        raise NotImplementedError(
            "rgenoud_operators=False (the legacy operator mix) is not "
            "ported to PyTorch yet (ROADMAP.md Queue 1 item 10)")
    il, target, att, limit, budget = arrays
    pop, fitness = carry
    children = _rgenoud_children(draws, pop, fitness, cfg, gen_frac)

    # --- elitism ------------------------------------------------------------
    elite_idx = torch.argsort(fitness, stable=True)[:cfg.elite]
    child_fit = recovery_ops.basis_risk(il, target, children, att, limit,
                                        budget)
    # children replace all but the elite slots
    new_pop = children.clone()
    new_pop[:cfg.elite] = pop[elite_idx]
    new_fit = child_fit.clone()
    new_fit[:cfg.elite] = fitness[elite_idx]

    # --- derivative polish of top-k (rgenoud's quasi-Newton step) -----------
    top_idx = torch.argsort(new_fit, stable=True)[:cfg.polish_k]
    polished = _polish(arrays, cfg, new_pop[top_idx])
    pol_fit = recovery_ops.basis_risk(il, target, polished, att, limit,
                                      budget)
    old_fit = new_fit[top_idx]
    better = pol_fit < old_fit
    new_pop[top_idx] = torch.where(better[:, None], polished,
                                   new_pop[top_idx])
    new_fit[top_idx] = torch.minimum(pol_fit, old_fit)
    return (new_pop, new_fit), torch.min(new_fit)


def _migrate_ring(pops: Sequence[torch.Tensor], fits: Sequence[torch.Tensor],
                  k: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Every island sends its top-k individuals to the next island in the
    ring, all at once; the immigrants replace the receiver's k worst (by
    its fitness before the exchange)."""
    n = len(pops)
    emigrants = []
    for pop, fit in zip(pops, fits):
        idx = torch.argsort(fit, stable=True)[:k]
        emigrants.append((pop[idx], fit[idx]))
    new_pops, new_fits = [], []
    for i, (pop, fit) in enumerate(zip(pops, fits)):
        imm_pop, imm_fit = emigrants[(i - 1) % n]
        worst = torch.argsort(fit, stable=True)[-k:]
        pop, fit = pop.clone(), fit.clone()
        pop[worst] = imm_pop.to(pop.device)
        fit[worst] = imm_fit.to(fit.device)
        new_pops.append(pop)
        new_fits.append(fit)
    return new_pops, new_fits


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def optimize_island(problem: CatBondProblem, cfg: GAConfig, seed: int = 0,
                    pop0: Optional[torch.Tensor] = None,
                    draws: Optional[Callable[[int], GenDraws]] = None,
                    device: DeviceLike = None):
    """Single-island GA (the instance / workstation path) on ``device``
    (``cuda`` unless given; the problem moves there).

    ``seed`` seeds the island's generator, which draws the initial
    population (unless ``pop0`` is given) and every generation's
    :class:`GenDraws` (unless ``draws`` is given).  Returns the best ``w``
    and its ``fitness``, the best fitness after each generation
    (``history``), and the final ``pop`` and ``pop_fitness``, on the
    device.  Fitness calls: ``1 + generations * (polish_steps + 2)``."""
    dev = resolve_device(device)
    problem = problem.to(dev)
    arrays = problem.arrays()
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        pop = (pop0.to(dev) if pop0 is not None
               else _init_pop(gen, cfg.pop_size, problem.n_dims, dev))
        if draws is None:
            draws = Draws(gen, pop.shape[0], problem.n_dims, cfg, dev)
        fit = basis_risk(problem, pop)
        hist = []
        for g in range(cfg.generations):
            (pop, fit), best = _ga_generation(
                arrays, cfg, (pop, fit), draws(g),
                gen_frac=g / max(cfg.generations, 1))
            hist.append(best)
        best = torch.argmin(fit)
        history = (torch.stack(hist) if hist
                   else torch.empty(0, device=dev))
    return {"w": pop[best], "fitness": fit[best], "history": history,
            "pop": pop, "pop_fitness": fit}


def island_seed(seed: int, island: int) -> int:
    """The generator seed of island ``island`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed, island]).generate_state(1)[0])


def optimize_islands(problem: CatBondProblem, cfg: GAConfig, seed: int = 0,
                     devices: Optional[Sequence[DeviceLike]] = None):
    """Island GA with one island per device (every CUDA device unless
    given), each with ``cfg.pop_size`` individuals and its own generator
    (:func:`island_seed`); ring migration every ``cfg.migrate_every``
    generations.  Generations are issued island by island, so islands on
    different cards overlap.  Returns host values: the best island's
    ``w`` and ``fitness``, each island's best per epoch (``history``,
    (n_islands, n_epochs)) and ``n_islands``."""
    devs = [resolve_device(d)
            for d in (cuda_devices() if devices is None else devices)]
    n_islands = len(devs)
    if n_islands == 0:
        raise ValueError("optimize_islands needs at least one device")
    n_epochs = max(1, cfg.generations // cfg.migrate_every)
    G = max(cfg.generations, 1)
    with torch.no_grad():
        arrays, pops, fits, draws = [], [], [], []
        for i, dev in enumerate(devs):
            prob = problem.to(dev)
            gen = torch.Generator(device=dev).manual_seed(
                island_seed(seed, i))
            pop = _init_pop(gen, cfg.pop_size, prob.n_dims, dev)
            arrays.append(prob.arrays())
            pops.append(pop)
            fits.append(basis_risk(prob, pop))
            draws.append(Draws(gen, cfg.pop_size, prob.n_dims, cfg, dev))
        hist: List[List[torch.Tensor]] = [[] for _ in devs]
        for e in range(n_epochs):
            bests: List[List[torch.Tensor]] = [[] for _ in devs]
            for j in range(cfg.migrate_every):
                g = e * cfg.migrate_every + j
                for i in range(n_islands):
                    (pops[i], fits[i]), b = _ga_generation(
                        arrays[i], cfg, (pops[i], fits[i]), draws[i](g),
                        gen_frac=g / G)
                    bests[i].append(b)
            pops, fits = _migrate_ring(pops, fits, cfg.migrate_k)
            for i in range(n_islands):
                hist[i].append(torch.stack(bests[i]).min())
        best_fit = np.array([float(f.min()) for f in fits])
        best_island = int(np.argmin(best_fit))
        w = pops[best_island][torch.argmin(fits[best_island])]
        history = np.array([[float(h) for h in row] for row in hist])
    return {"w": w.cpu().numpy(), "fitness": float(best_fit[best_island]),
            "history": history, "n_islands": n_islands}
