"""The port's paged attention against the JAX package's.

On the CPU: the plain version (``repro_torch.kernels.paged_attention.ref``)
and the op boundary against ``repro.kernels.paged_attention.ref`` — and
once against the Pallas kernel in interpret mode — on the same numpy
inputs, fp32, tolerance 1e-5 relative.  Outputs are compared on live rows
(padded rows are garbage by contract on every backend); pools on every
page but the null page 0 (the JAX oracle dumps padded rows there, the
port leaves it untouched, the TPU and CUDA kernels do not write it).

The CUDA kernel itself is tested on the card by ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ref as jax_ref
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref

FULL = 1 << 30
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_case(seed, *, S, filled, ns, Hkv, G, BS, MB, D=16):
    """Random pools/tables for one step.  filled[b] = tokens already in
    row b's cache; ns[b] = fresh tokens (0 = padded row, null table).
    Pools are random everywhere, so a leaky mask picks up garbage."""
    rng = np.random.default_rng(seed)
    B = len(filled)
    NB = 1 + B * MB
    pos = np.full((B, S), -1, np.int32)
    tables = np.zeros((B, MB), np.int32)
    page = 1
    for b, (f, n) in enumerate(zip(filled, ns)):
        if n > 0:
            pos[b, :n] = f + np.arange(n)
            nblk = (f + n - 1) // BS + 1
            tables[b, :nblk] = np.arange(page, page + nblk)
            page += nblk
    arr = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return dict(q=arr(B, S, Hkv * G, D), kn=arr(B, S, Hkv, D),
                vn=arr(B, S, Hkv, D), kp=arr(NB, BS, Hkv, D),
                vp=arr(NB, BS, Hkv, D), tables=tables, pos=pos,
                live=int(pos.max()) // BS + 1 if (pos >= 0).any() else 1)


def jax_update(c, *, window, softcap, live=None):
    kp, vp = jax_ref.write_kv(jnp.asarray(c["kp"]), jnp.asarray(c["vp"]),
                              jnp.asarray(c["kn"]), jnp.asarray(c["vn"]),
                              jnp.asarray(c["pos"]), jnp.asarray(c["tables"]))
    out = jax_ref.paged_attention(
        jnp.asarray(c["q"]), kp, vp, jnp.asarray(c["tables"]),
        jnp.asarray(c["pos"]), window=jnp.asarray(window, jnp.int32),
        softcap=softcap, max_live_blocks=c["live"] if live is None else live)
    return np.asarray(out), np.asarray(kp), np.asarray(vp)


def torch_update(c, *, window, softcap, live=None, fn=None):
    t = {k: torch.from_numpy(np.array(c[k]))
         for k in ("q", "kn", "vn", "kp", "vp", "tables", "pos")}
    fn = fn or pa_ref.unified_attention_update
    out, kp, vp = fn(t["q"], t["kn"], t["vn"], t["kp"], t["vp"],
                     t["tables"], t["pos"], window=window, softcap=softcap,
                     max_live_blocks=c["live"] if live is None else live)
    return out.numpy(), kp.numpy(), vp.numpy()


def assert_parity(c, got, want, rtol=RTOL):
    live = c["pos"] >= 0
    out_g, out_w = got[0][live], want[0][live]
    np.testing.assert_allclose(out_g, out_w, rtol=rtol,
                               atol=rtol * np.abs(out_w).max())
    assert np.isfinite(got[0]).all()
    for pg, pw in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(pg[1:], pw[1:])


def test_write_kv_matches_jax_and_spares_null_page():
    c = make_case(0, S=3, filled=[2, 5, 0], ns=[3, 1, 0], Hkv=2, G=2,
                  BS=4, MB=3)
    want = jax_ref.write_kv(*(jnp.asarray(c[k]) for k in
                              ("kp", "vp", "kn", "vn", "pos", "tables")))
    kp, vp = torch.from_numpy(c["kp"].copy()), torch.from_numpy(
        c["vp"].copy())
    got = pa_ref.write_kv(kp, vp, torch.from_numpy(c["kn"]),
                          torch.from_numpy(c["vn"]),
                          torch.from_numpy(c["pos"]),
                          torch.from_numpy(c["tables"]))
    assert got[0] is kp and got[1] is vp            # in place
    for g, w, orig in zip(got, want, (c["kp"], c["vp"])):
        np.testing.assert_array_equal(g.numpy()[1:], np.asarray(w)[1:])
        np.testing.assert_array_equal(g.numpy()[0], orig[0])


@pytest.mark.parametrize("G", [1, 4, 8])
def test_ragged_gqa(G):
    """Ragged decode rows (one idle) for MHA, GQA 4 and MQA-like 8."""
    c = make_case(1, S=1, filled=[0, 6, 13, 3], ns=[1, 1, 1, 0], Hkv=2,
                  G=G, BS=4, MB=5)
    assert_parity(c, torch_update(c, window=FULL, softcap=0.0),
                  jax_update(c, window=FULL, softcap=0.0))


def test_chunk_crossing_pages_with_padded_tail():
    """A prefill chunk that straddles page boundaries, a chunk tail padded
    with -1, and a padded (idle) request row."""
    c = make_case(2, S=7, filled=[3, 9, 0], ns=[7, 4, 0], Hkv=1, G=4,
                  BS=4, MB=5)
    got = torch_update(c, window=FULL, softcap=0.0)
    assert_parity(c, got, jax_update(c, window=FULL, softcap=0.0))
    assert np.isfinite(got[0][2]).all()      # fully padded row: finite


def test_window_and_softcap():
    """A sliding window (``reduced(cfg, sliding_window=8)``) with a logit
    softcap, across a chunk and several pages."""
    c = make_case(3, S=5, filled=[11, 2], ns=[5, 3], Hkv=2, G=2, BS=4,
                  MB=5)
    assert_parity(c, torch_update(c, window=8, softcap=30.0),
                  jax_update(c, window=8, softcap=30.0))


def test_live_block_bound_below_table_width():
    """Walking only the live blocks equals gathering the whole table."""
    c = make_case(4, S=2, filled=[1, 4], ns=[2, 2], Hkv=1, G=2, BS=4, MB=8)
    assert c["live"] < 8
    got = torch_update(c, window=FULL, softcap=0.0)
    assert_parity(c, got, jax_update(c, window=FULL, softcap=0.0, live=8))
    assert_parity(c, got, torch_update(c, window=FULL, softcap=0.0, live=8))


def test_unified_ragged_view_matches_flat_oracle():
    """The unified tick's op (per-request view through ``row_map``) equals
    the JAX flat scatter-first oracle: decode rows and a prefill segment
    straddling a page, one token per flat row."""
    rng = np.random.default_rng(5)
    Hkv, G, D, BS, MB = 2, 2, 16, 4, 4
    # flat rows: req0 decode at 6, req1 prefill 2..6, then padded tail
    owner = [0, 1, 1, 1, 1, 1, -1, -1]
    posf = np.array([6, 2, 3, 4, 5, 6, -1, -1], np.int32)
    T = len(owner)
    req_tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [0, 0, 0, 0]],
                          np.int32)
    row_map = np.full((3, 5), T - 1, np.int32)
    row_map[0, 0] = 0
    row_map[1, :5] = np.arange(1, 6)
    tok_tables = np.stack([req_tables[o] if o >= 0 else req_tables[2]
                           for o in owner])
    NB = 5
    q = rng.standard_normal((T, 1, Hkv * G, D)).astype(np.float32)
    kn = rng.standard_normal((T, 1, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((T, 1, Hkv, D)).astype(np.float32)
    kp = rng.standard_normal((NB, BS, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((NB, BS, Hkv, D)).astype(np.float32)
    want = jax_ref.unified_attention_update(
        *(jnp.asarray(a) for a in (q, kn, vn, kp, vp, tok_tables,
                                   posf[:, None])),
        window=jnp.asarray(FULL, jnp.int32), softcap=0.0, max_live_blocks=2)
    got = pa_ops.paged_attention_unified(
        *(torch.from_numpy(a.copy()) for a in (q, kn, vn, kp, vp,
                                               req_tables, posf[:, None],
                                               row_map)),
        window=FULL, softcap=0.0, max_live_blocks=2)
    c = {"pos": posf[:, None]}
    assert_parity(c, [g.numpy() for g in got],
                  [np.asarray(w) for w in want])


def test_matches_pallas_kernel_in_interpret_mode():
    """One tiny case against the TPU kernel itself, run as the JAX tests
    run it on the CPU (Pallas interpret mode)."""
    from repro.kernels.paged_attention.kernel import \
        paged_attention_update_pallas
    c = make_case(6, S=3, filled=[5, 0], ns=[3, 2], Hkv=1, G=2, BS=4, MB=3)
    out, kp, vp = paged_attention_update_pallas(
        *(jnp.asarray(c[k]) for k in ("q", "kn", "vn", "kp", "vp",
                                      "tables", "pos")),
        window=jnp.asarray(FULL, jnp.int32), softcap=0.0,
        max_live_blocks=c["live"], interpret=True)
    assert_parity(c, torch_update(c, window=FULL, softcap=0.0),
                  (np.asarray(out), np.asarray(kp), np.asarray(vp)))


def test_kernel_wrapper_runs_plain_version_on_cpu():
    """CPU tensors take the plain version and launch nothing."""
    c = make_case(7, S=2, filled=[3, 1], ns=[2, 1], Hkv=2, G=2, BS=4, MB=3)
    before = pa_kernel.launches
    got = torch_update(c, window=6, softcap=0.0,
                       fn=pa_kernel.paged_attention_update)
    assert pa_kernel.launches == before
    assert_parity(c, got, torch_update(c, window=6, softcap=0.0))


@pytest.mark.parametrize("bad,err", [
    ("head_dim", ValueError), ("dtype", TypeError),
    ("tables_dtype", TypeError), ("block_size", ValueError),
    ("contiguous", ValueError), ("alignment", ValueError)])
def test_kernel_wrapper_checks(bad, err):
    """What the CUDA wrapper refuses before any launch (the checks run on
    any device)."""
    B, S, H, Hkv, D, NB, BS, MB = 2, 1, 4, 2, 16, 5, 4, 2
    q = torch.zeros(B, S, H, D)
    kn = torch.zeros(B, S, Hkv, D)
    pool = torch.zeros(NB, BS, Hkv, D)
    tables = torch.zeros(B, MB, dtype=torch.int32)
    pos = torch.zeros(B, S, dtype=torch.int32)
    if bad == "head_dim":
        q, kn, pool = q[..., :8], kn[..., :8], pool[..., :8].contiguous()
        q, kn = q.contiguous(), kn.contiguous()
    elif bad == "dtype":
        q, kn, pool = q.half(), kn.half(), pool.half()
    elif bad == "tables_dtype":
        tables = tables.long()
    elif bad == "block_size":
        pool = torch.zeros(NB, 128, Hkv, D)
    elif bad == "contiguous":
        q = torch.zeros(B, S, D, H).transpose(2, 3)
    elif bad == "alignment":
        q = torch.zeros(B * S * H * D + 1)[1:].view(B, S, H, D)
    with pytest.raises(err):
        pa_kernel._check(q, kn, kn, pool, pool, tables, pos)
