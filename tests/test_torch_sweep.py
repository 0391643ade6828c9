"""The port's sweep engine: ports of
tests/test_checkpoint_ft.py::test_straggler_speculation_recovers and
tests/test_properties.py::test_sweep_every_point_exactly_once (there a
hypothesis property; here a fixed grid of the same parameters), on CPU
devices, plus the paper's Monte-Carlo sweep on both paths against the
JAX package's ``sweep_vmapped`` on the same per-point noise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sweep import sweep_vmapped as jax_sweep_vmapped
from repro_torch.core.sweep import SweepEngine, sweep_vmapped
from repro_torch.ft.straggler import StragglerPolicy

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_straggler_speculation_recovers():
    """A device that sleeps on every task must not stall the sweep."""
    slow_device = 1

    def injector(dev_idx, task_idx):
        return 1.0 if dev_idx == slow_device else 0.0

    engine = SweepEngine([CPU] * 4, over_decompose=3, speculate=True,
                         straggler_policy=StragglerPolicy(factor=2.0,
                                                          min_samples=2),
                         slowdown_injector=injector)
    pts = {"x": np.arange(24.0)}
    out = engine.run(lambda p: p["x"] + 1.0, pts)
    np.testing.assert_allclose(out, pts["x"] + 1.0)
    rep = engine.last_report
    assert rep.wall_time < 10.0
    assert sum(rep.device_task_counts.values()) == rep.n_tasks == 12


@pytest.mark.parametrize("n_points,over,fake_devs,placement", [
    (1, 1, 1, "bynode"), (7, 3, 4, "bynode"), (100, 7, 3, "byslot"),
    (13, 2, 2, "byslot"), (64, 4, 4, "bynode"), (5, 7, 4, "byslot")])
def test_sweep_every_point_exactly_once(n_points, over, fake_devs, placement):
    """Task-queue sweep returns every point's result exactly once, in order,
    regardless of placement policy and decomposition."""
    engine = SweepEngine([CPU] * fake_devs, placement=placement,
                         over_decompose=over, speculate=False)
    pts = {"x": np.arange(float(n_points))}
    out = engine.run(lambda p: p["x"] * 3.0 + 1.0, pts)
    np.testing.assert_allclose(out, pts["x"] * 3.0 + 1.0)
    rep = engine.last_report
    assert rep.n_points == n_points
    assert sum(rep.device_task_counts.values()) == rep.n_tasks


def mc_price(pt):
    """examples/param_sweep.py's option price, with the point's noise
    given (vmap splits no generator)."""
    path = torch.exp(torch.cumsum(pt["z"] * pt["sigma"] + pt["drift"], 0)
                     * 0.001)
    return {"price": torch.clamp(path[-1] - 1.0, min=0.0), "idx": pt["idx"]}


def jax_mc_price(pt):
    path = jnp.exp(jnp.cumsum(pt["z"] * pt["sigma"] + pt["drift"]) * 0.001)
    return jnp.maximum(path[-1] - 1.0, 0.0)


def test_monte_carlo_sweep_both_paths_match_jax():
    n, steps = 48, 512
    rng = np.random.default_rng(0)
    pts = {"z": rng.standard_normal((n, steps)).astype(np.float32),
           "sigma": np.linspace(0.1, 2.0, n, dtype=np.float32),
           "drift": np.linspace(-0.5, 0.5, n, dtype=np.float32),
           "idx": np.arange(n)}
    want = np.asarray(jax_sweep_vmapped(
        jax_mc_price, {k: jnp.asarray(v) for k, v in pts.items()
                       if k != "idx"}))
    fast = sweep_vmapped(mc_price, pts, device=CPU)
    np.testing.assert_allclose(fast["price"].numpy(), want, rtol=1e-5,
                               atol=1e-6)
    engine = SweepEngine([CPU] * 3, over_decompose=4)
    out = engine.run(mc_price, pts)
    np.testing.assert_array_equal(out["idx"], np.arange(n))
    np.testing.assert_allclose(out["price"], fast["price"].numpy(),
                               rtol=1e-6, atol=1e-7)
    assert engine.last_report.n_tasks == 12


def test_sweep_vmapped_mesh_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        sweep_vmapped(lambda p: p, {"x": np.ones(2)}, mesh=object(),
                      device=CPU)


def test_worker_error_reaches_the_caller():
    def boom(p):
        raise ValueError("bad point")

    with pytest.raises(ValueError, match="bad point"):
        SweepEngine([CPU] * 2, speculate=False).run(boom,
                                                     {"x": np.ones(4)})


def test_sweep_defaults_to_every_gpu():
    if torch.cuda.is_available():
        assert len(SweepEngine().devices) == torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SweepEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_vmapped(lambda p: p, {"x": np.ones(2)})
