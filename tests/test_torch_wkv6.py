"""The port's RWKV-6 recurrence (``repro_torch.kernels.wkv6``: the plain
version, the model's exact scan, and the op boundary) against the JAX
package's, on the same numpy inputs, at the shapes of the JAX package's
``test_wkv6_vs_ref``.

Tolerances: the scan against JAX's scan and against the Pallas kernel in
interpret mode 2e-5 relative and absolute (fp32, the same order of
operations, sums over D taken in another order); the final state likewise.
The CUDA kernel's cases are in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import ops as jax_ops
from repro.kernels.wkv6 import ref as jax_ref
from repro.models.rwkv6 import wkv_scan as jax_scan
from repro_torch.kernels.wkv6 import kernel, ops, ref
from repro_torch.models.rwkv6 import wkv_scan

TOL = 2e-5
# (B, S, H, D, chunk): test_wkv6_vs_ref's shapes
SHAPES = [(2, 64, 4, 16, 16), (1, 96, 2, 32, 32), (2, 128, 3, 64, 64),
          (1, 64, 1, 128, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, S, H, D):
    """r, k, v normal; w = sigmoid(normal); u = normal x 0.1, as the JAX
    test draws them; float32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, H, D))))).astype(
        np.float32)
    u = (rng.standard_normal((H, D)) * 0.1).astype(np.float32)
    return r, k, v, w, u


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,S,H,D,chunk", SHAPES)
def test_ref_matches_jax_ref(B, S, H, D, chunk):
    x = _inputs(0, B, S, H, D)
    got = ref.wkv(*_t(*x))
    assert got.dtype == torch.float32 and got.shape == (B, S, H, D)
    _close(got.numpy(), jax_ref.wkv(*_j(*x)))


@pytest.mark.parametrize("B,S,H,D,chunk", SHAPES)
def test_op_matches_jax_pallas_interpret(B, S, H, D, chunk):
    """The op on CPU tensors (the plain version) against the TPU kernel run
    in interpret mode, chunked as the JAX test chunks it."""
    x = _inputs(1, B, S, H, D)
    want = jax_ops.wkv(*_j(*x), use_pallas=True, interpret=True,
                       chunk=chunk)
    before = kernel.launches
    got = ops.wkv(*_t(*x), chunk=chunk)
    assert kernel.launches == before        # the plain path launches none
    _close(got.numpy(), want)


@pytest.mark.parametrize("B,S,H,D,chunk", SHAPES)
def test_scan_from_a_state_matches_jax(B, S, H, D, chunk):
    """``state0`` carried in, and the final state out."""
    x = _inputs(2, B, S, H, D)
    s0 = np.random.default_rng(3).standard_normal(
        (B, H, D, D)).astype(np.float32)
    out, st = wkv_scan(*_t(*x), torch.from_numpy(s0))
    jout, jst = jax_scan(*_j(*x), jnp.asarray(s0))
    _close(out.numpy(), jout)
    _close(st.numpy(), jst)


@pytest.mark.parametrize("block", [4, 16, 48])
def test_scan_block_matches_jax(block):
    """``block`` > 1 regroups the JAX scan's steps exactly; the port's
    loop gives the same result for every block."""
    x = _inputs(4, 2, 48, 2, 16)
    out, st = wkv_scan(*_t(*x), block=block)
    out1, st1 = wkv_scan(*_t(*x))
    assert torch.equal(out, out1) and torch.equal(st, st1)
    jout, jst = jax_scan(*_j(*x), block=block)
    _close(out.numpy(), jout)
    _close(st.numpy(), jst)


def test_op_device_rules():
    """CPU tensors run the plain version, cast to r's dtype; anything else
    that is not CUDA raises, and so do mixed devices."""
    r, k, v, w, u = _t(*_inputs(5, 1, 12, 2, 16))
    rb, kb, vb = (t.to(torch.bfloat16) for t in (r, k, v))
    got = ops.wkv(rb, kb, vb, w, u)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.wkv(rb, kb, vb, w, u).to(torch.bfloat16))
    meta = [t.to("meta") for t in (r, k, v, w, u)]
    with pytest.raises(ValueError, match="no kernel"):
        ops.wkv(*meta)
    with pytest.raises(ValueError, match="share a device"):
        ops.wkv(r, k, v, w.to("meta"), u)
    with pytest.raises(ValueError, match="chunk"):
        ops.wkv(r, k, v, w, u, chunk=0)


def test_plain_version_has_a_gradient_on_cpu():
    """On the CPU the op is the plain scan, which autograd differentiates
    (only the CUDA kernel has no gradient): d sum(out) / du against its
    closed form, within 1e-5 (fp32 sums of ten terms)."""
    r, k, v, w, u = _t(*_inputs(6, 1, 10, 1, 16))
    ug = u.clone().requires_grad_(True)
    ops.wkv(r, k, v, w, ug).sum().backward()
    # d out_t / d u_i = r_ti k_ti v_t, summed over t and the output axis
    want = (r * k * v.sum(-1, keepdim=True)).sum((0, 1))
    torch.testing.assert_close(ug.grad, want, rtol=1e-5, atol=1e-5)


def test_kernel_rejects_what_it_does_not_take():
    """The wrapper's checks run before any build: head dims outside
    (16, 32, 64, 128), mixed r/k/v dtypes, a strided last axis."""
    r, k, v, w, u = _t(*_inputs(7, 1, 4, 2, 16))
    kernel._check(r, k, v, w, u)
    r24, k24, v24, w24 = (torch.zeros(1, 4, 2, 24) for _ in range(4))
    with pytest.raises(ValueError, match="head dim 24"):
        kernel._check(r24, k24, v24, w24, torch.zeros(2, 24))
    with pytest.raises(TypeError, match="share a dtype"):
        kernel._check(r, k.to(torch.bfloat16), v, w, u)
    with pytest.raises(TypeError, match="float16"):
        kernel._check(r, k, v, w.to(torch.float16), u)
    wide = torch.zeros(1, 4, 2, 32)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        kernel._check(r, k, v, wide, u)
    with pytest.raises(ValueError, match="u must be"):
        kernel._check(r, k, v, w, u[:1])
