"""The port's CATopt fitness against the JAX package's.

On the CPU the kernel wrapper runs its plain version, and the op boundary
its autograd Function (forward: the wrapper; backward: the plain products
of ``ops._FitnessSq``).  Both meet the JAX reference
(``repro.kernels.recovery.ref``) and the Pallas kernel in interpret mode on
the same numpy inputs at ``test_recovery_vs_ref``'s four shapes, within
1e-4 (relative and absolute, fp32: summation order).  The gradient meets
``jax.grad`` of the JAX reference within 1e-4.

The CUDA kernel itself is tested on the card by ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.recovery import ops as jax_ops
from repro.kernels.recovery import ref as jax_ref
from repro_torch.kernels.recovery import kernel as rec_kernel
from repro_torch.kernels.recovery import ops as rec_ops
from repro_torch.kernels.recovery import ref as rec_ref

TOL = 1e-4
SHAPES = [(256, 128, 16), (500, 300, 37), (128, 512, 64), (1024, 256, 8)]
ATT, LIMIT, BUDGET = 5.0, 20.0, 30.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_inputs(seed, E, m, P, w_scale=1.0):
    """test_recovery_vs_ref's inputs, from numpy: |normal| losses and
    targets, uniform weights times ``w_scale``."""
    rng = np.random.default_rng(seed)
    il = np.abs(rng.standard_normal((E, m))).astype(np.float32)
    w = (rng.uniform(size=(P, m)) * w_scale).astype(np.float32)
    target = np.abs(rng.standard_normal(E)).astype(np.float32)
    return il, w, target


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("E,m,P", SHAPES)
def test_basis_risk_vs_jax_ref(E, m, P):
    il, w, target = make_inputs(0, E, m, P)
    want = np.asarray(jax_ref.basis_risk(jnp.asarray(il), jnp.asarray(target),
                                         jnp.asarray(w), ATT, LIMIT, BUDGET))
    for fn in (rec_ops.basis_risk, rec_ref.basis_risk):
        got = fn(_t(il), _t(target), _t(w), ATT, LIMIT, BUDGET).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("E,m,P", SHAPES)
def test_basis_risk_vs_jax_pallas_interpret(E, m, P):
    """The Pallas kernel in interpret mode, as test_recovery_vs_ref runs
    it; the port's boundary has no padding."""
    il, w, target = make_inputs(1, E, m, P)
    want = np.asarray(jax_ops.basis_risk(
        jnp.asarray(il), jnp.asarray(target), jnp.asarray(w), ATT, LIMIT,
        BUDGET, use_pallas=True, interpret=True))
    got = rec_ops.basis_risk(_t(il), _t(target), _t(w), ATT, LIMIT,
                             BUDGET).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("E,m,P", SHAPES)
def test_fitness_sq_plain_vs_jax(E, m, P):
    """The wrapper on CPU tensors is the plain version; the sum of squared
    errors equals E x the JAX reference's mse."""
    il, w, target = make_inputs(2, E, m, P)
    rec = jax_ref.recovery(jnp.asarray(il), jnp.asarray(w), ATT, LIMIT)
    want = np.asarray(jnp.sum(jnp.square(rec - jnp.asarray(target)), -1))
    before = rec_kernel.launches
    got = rec_kernel.fitness_sq(_t(il), _t(w), _t(target), ATT, LIMIT).numpy()
    assert rec_kernel.launches == before      # the plain version counts none
    np.testing.assert_allclose(got, want, rtol=TOL)


@pytest.mark.parametrize("E,m,P", SHAPES)
@pytest.mark.parametrize("att", [ATT, -3.0])
def test_gradient_vs_jax_grad(E, m, P, att):
    """d(sum of basis risk)/dw through the port's autograd Function and
    through plain autograd, against jax.grad of the JAX reference.  The
    weights are scaled so that the mean loss is att + limit / 2 and the
    events' losses are spread over 0 to three times that: the clip's mask is
    live for some events and not others, and the budget penalty is active
    for some rows only."""
    scale = 2 * (att + LIMIT / 2) / (0.8 * m)
    il, w, target = make_inputs(3, E, m, P, w_scale=scale)
    il *= np.random.default_rng(30).uniform(0, 3, (E, 1)).astype(np.float32)
    budget = float(w.sum(-1).mean())

    def jax_obj(w_):
        return jnp.sum(jax_ref.basis_risk(jnp.asarray(il), jnp.asarray(target),
                                          w_, att, LIMIT, budget))

    want = np.asarray(jax.grad(jax_obj)(jnp.asarray(w)))
    rec = np.asarray(jax_ref.recovery(jnp.asarray(il), jnp.asarray(w), att,
                                      LIMIT))
    live = (rec > 0) & (rec < LIMIT)
    assert 0.05 < live.mean() < 0.95      # the clip's mask is exercised
    for fn in (rec_ops.basis_risk, rec_ref.basis_risk):
        wt = _t(w.copy()).requires_grad_(True)
        fn(_t(il), _t(target), wt, att, LIMIT, budget).sum().backward()
        np.testing.assert_allclose(wt.grad.numpy(), want, atol=TOL,
                                   rtol=TOL)


def test_negative_attachment_vs_jax_ref():
    """att < 0: every event, also a zero-loss one, pays clip(-att, ...);
    the port has no zero-padded events to get wrong."""
    il, w, target = make_inputs(4, 500, 300, 37)
    want = np.asarray(jax_ref.basis_risk(jnp.asarray(il), jnp.asarray(target),
                                         jnp.asarray(w), -4.0, 200.0, BUDGET))
    got = rec_ops.basis_risk(_t(il), _t(target), _t(w), -4.0, 200.0,
                             BUDGET).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_batch_shape_kept():
    il, w, target = make_inputs(5, 64, 16, 6)
    got = rec_ops.basis_risk(_t(il), _t(target), _t(w).reshape(2, 3, 16),
                             ATT, LIMIT, BUDGET)
    assert got.shape == (2, 3)
    flat = rec_ops.basis_risk(_t(il), _t(target), _t(w), ATT, LIMIT, BUDGET)
    torch.testing.assert_close(got.reshape(-1), flat, rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    il, w, target = make_inputs(6, 8, 4, 2)
    with pytest.raises(ValueError):
        rec_kernel.fitness_sq(_t(il).to("meta"), _t(w).to("meta"),
                              _t(target).to("meta"), ATT, LIMIT)


def test_gradient_to_losses_refused():
    il, w, target = make_inputs(7, 16, 8, 3)
    ilt = _t(il).requires_grad_(True)
    out = rec_ops.basis_risk(ilt, _t(target), _t(w), ATT, LIMIT, BUDGET)
    with pytest.raises(NotImplementedError):
        out.sum().backward()
