"""The port's flash attention (``repro_torch.kernels.flash_attention``) on
the CPU, where the op boundary runs the plain versions, against the JAX
package: its dense oracle (``fa_ref.attention``), its Pallas kernels in
interpret mode (``fa_ops.attention(use_pallas=True)``,
``flash_attention_fwd_lse``, ``flash_attention_bwd``) and ``jax.grad``.

Tolerances as ``tests/test_kernels.py`` states them: forward 3e-5 in fp32
and 2e-2 in bf16 (the oracle rounds q * D^-0.5 and the normalised p to
bf16; the flash form rounds fp32 q, unnormalised p), gradients 2e-4.  The
same inputs, drawn with numpy, go to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as fa_ops
from repro.kernels.flash_attention import ref as fa_ref
from repro.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                  flash_attention_fwd_lse)
from repro_torch.kernels.flash_attention import kernel, ops, ref

# (B, S, H, Hkv, D): three of test_kernels.py's shapes, head dim 16 with
# MQA, and a ragged S that is no multiple of the CUDA kernels' 64-row tiles
SHAPES = [(2, 128, 4, 2, 64), (1, 128, 6, 3, 128), (2, 64, 4, 4, 64),
          (1, 200, 8, 1, 16)]
MASKS = [(True, 0, 0.0), (True, 32, 0.0), (False, 0, 0.0), (True, 0, 30.0)]
DTYPES = {"float32": (torch.float32, jnp.float32, 3e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
GRAD_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, S, H, Hkv, D, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32))


def _flat(x):
    """(B, S, H, D) numpy -> (B*H, S, D), the kernels' layout."""
    B, S, H, D = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, D))


def _np(x):
    return np.array(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window,softcap", MASKS)
@pytest.mark.parametrize("B,S,H,Hkv,D", SHAPES)
def test_forward_matches_jax_oracle(B, S, H, Hkv, D, causal, window,
                                    softcap, dtype):
    """ops.attention (the plain forward on the CPU) against the oracle."""
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v = _inputs(0, B, S, H, Hkv, D)
    want = fa_ref.attention(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
                            causal=causal, window=window, softcap=softcap)
    got = ops.attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                        causal=causal, window=window, softcap=softcap)
    assert got.dtype == tdt and got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("causal,window,softcap", MASKS[:2])
@pytest.mark.parametrize("B,S,H,Hkv,D", [SHAPES[0], SHAPES[1], SHAPES[3]])
def test_forward_matches_pallas_interpret(B, S, H, Hkv, D, causal, window,
                                          softcap):
    """ops.attention against the TPU kernel's own forward (interpret)."""
    q, k, v = _inputs(1, B, S, H, Hkv, D)
    want = fa_ops.attention(*(jnp.asarray(x) for x in (q, k, v)),
                            causal=causal, window=window, softcap=softcap,
                            use_pallas=True, interpret=True, block_q=64,
                            block_k=64)
    got = ops.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                        causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("causal,window,softcap", [MASKS[1], MASKS[3]])
def test_forward_lse_matches_pallas_interpret(causal, window, softcap):
    """The forward with lse (flat layout) against flash_attention_fwd_lse:
    out and lse."""
    B, S, H, Hkv, D = 2, 96, 4, 2, 32
    q, k, v = (_flat(x) for x in _inputs(2, B, S, H, Hkv, D))
    o_j, lse_j = flash_attention_fwd_lse(
        *(jnp.asarray(x) for x in (q, k, v)), n_q_heads=H, causal=causal,
        window=window, softcap=softcap, block_q=32, block_k=32,
        interpret=True)
    o, lse = kernel.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                              n_q_heads=H, causal=causal, window=window,
                              softcap=softcap, with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B * H, S)
    np.testing.assert_allclose(o.numpy(), _np(o_j), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(lse.numpy(), _np(lse_j), atol=3e-5,
                               rtol=3e-5)


@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window,softcap", [
    (2, 128, 4, 2, 64) + m for m in MASKS] + [(1, 72, 4, 1, 16) + MASKS[1]])
def test_backward_matches_pallas_interpret(B, S, H, Hkv, D, causal, window,
                                           softcap):
    """ref.flash_bwd against flash_attention_bwd on the same residuals:
    dq and the per-query-head dk, dv; and the kernel wrapper's CPU path
    returns their group sums onto the KV heads."""
    q, k, v = (_flat(x) for x in _inputs(3, B, S, H, Hkv, D))
    do = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    o, lse = flash_attention_fwd_lse(
        *(jnp.asarray(x) for x in (q, k, v)), n_q_heads=H, causal=causal,
        window=window, softcap=softcap, block_q=32, block_k=32,
        interpret=True)
    dsum = jnp.sum(jnp.asarray(do) * o, axis=-1)
    want = flash_attention_bwd(
        *(jnp.asarray(x) for x in (q, k, v, do)), lse, dsum, n_q_heads=H,
        causal=causal, window=window, softcap=softcap, block_q=32,
        block_k=32, interpret=True)
    args = [torch.from_numpy(x) for x in (q, k, v, do)] + [
        torch.from_numpy(_np(lse)), torch.from_numpy(_np(dsum))]
    opts = dict(n_q_heads=H, causal=causal, window=window, softcap=softcap)
    got = ref.flash_bwd(*args, **opts)
    for name, a, b in zip(("dq", "dk per head", "dv per head"), got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)
    dq, dk, dv = kernel.flash_bwd(*args, **opts)
    assert dk.shape == dv.shape == (B * Hkv, S, D)
    np.testing.assert_array_equal(dq.numpy(), got[0].numpy())
    for a, b in ((dk, want[1]), (dv, want[2])):
        grouped = _np(b).reshape(B, Hkv, H // Hkv, S, D).sum(axis=2)
        np.testing.assert_allclose(a.numpy(), grouped.reshape(B * Hkv, S, D),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("causal,window,softcap", MASKS)
def test_trainable_grads_match_jax_grad(causal, window, softcap):
    """attention_trainable's autograd (forward with lse, backward op,
    per-KV-head dk/dv) against jax.grad through the oracle, as
    test_flash_attention_backward_kernels_vs_ref_grads holds the TPU
    kernels."""
    B, S, H, Hkv, D = 2, 128, 4, 2, 64
    q, k, v = _inputs(5, B, S, H, Hkv, D)

    def loss_ref(q, k, v):
        o = fa_ref.attention(q, k, v, causal=causal, window=window,
                             softcap=softcap)
        return jnp.sum(jnp.sin(o))

    want = jax.grad(loss_ref, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ops.attention_trainable(*ts, causal=causal, window=window,
                                  softcap=softcap)
    torch.sin(out).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), _np(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


def test_trainable_without_grad_is_the_plain_forward():
    """With no gradient wanted, attention_trainable runs the forward
    without lse: the same output as with one."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(6, 1, 80, 4, 2, 32))
    with torch.no_grad():
        a = ops.attention_trainable(q, k, v, window=16)
    b = ops.attention_trainable(q.requires_grad_(), k, v, window=16)
    assert b.requires_grad
    torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


def test_group_sum_folds_query_heads():
    x = torch.arange(2 * 6 * 3 * 2, dtype=torch.float32).reshape(12, 3, 2)
    got = ref.group_sum(x, n_q_heads=6, n_kv_rows=4)      # B 2, Hkv 2, G 3
    want = x.reshape(2, 2, 3, 3, 2).sum(dim=2).reshape(4, 3, 2)
    torch.testing.assert_close(got, want)


def test_wrappers_launch_nothing_on_the_cpu_and_refuse_other_devices():
    """The CPU path is the plain version and counts no launch; a tensor on
    another device is refused, never run by the plain version."""
    before = (kernel.fwd_launches, kernel.fwd_lse_launches,
              kernel.dq_launches, kernel.dkv_launches)
    q, k, v = (_flat(x) for x in _inputs(7, 1, 16, 2, 1, 16))
    args = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = kernel.flash_fwd(*args, n_q_heads=2, with_lse=True)
    kernel.flash_bwd(*args, o, lse, lse, n_q_heads=2)
    assert (kernel.fwd_launches, kernel.fwd_lse_launches,
            kernel.dq_launches, kernel.dkv_launches) == before
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="no kernel"):
        kernel.flash_fwd(*meta, n_q_heads=2)


@pytest.mark.parametrize("case", ["dtype", "head_dim", "heads", "layout",
                                  "lse"])
def test_kernel_checks_refuse_what_it_does_not_take(case):
    """The wrapper's checks, which run before any CUDA launch."""
    q = torch.zeros(4, 8, 16)
    k = torch.zeros(2, 8, 16)
    rows = {}
    if case == "dtype":
        q, k = q.double(), k.double()
    elif case == "head_dim":
        q, k = torch.zeros(4, 8, 320), torch.zeros(2, 8, 320)
    elif case == "heads":
        k = torch.zeros(3, 8, 16)
    elif case == "layout":
        q = torch.zeros(8, 4, 16).transpose(0, 1)
    else:
        rows = {"lse": torch.zeros(4, 8, dtype=torch.bfloat16)}
    with pytest.raises((TypeError, ValueError)):
        kernel._check(q, k, k.clone(), 2, **rows)


def test_flat_layout_is_contiguous_at_batch_one():
    """At B 1 the (B, S, H, D) -> (B*H, S, D) reshape alone can return a
    strided view, which the CUDA kernels refuse."""
    x = torch.arange(8 * 4 * 16.0).reshape(1, 8, 4, 16)
    assert not x.transpose(1, 2).reshape(4, 8, 16).is_contiguous()
    flat = ops._flat(x)
    assert flat.is_contiguous()
    assert torch.equal(ops._unflat(flat, 1), x)
