"""int8 KV pages and the read-only walk in the port, against the JAX package.

On the CPU, the same numpy inputs go through the JAX functions and the
port's plain versions (``repro_torch.kernels.paged_attention.ref``) and op
boundary:

  * ``quantize_rows`` and the int8 ``write_kv`` are bit-equal to JAX's:
    the int8 rows and the fp32 scales (the recipe rounds half to even and
    multiplies by fp32(1/127));
  * the walks (``paged_attention``, fp and int8; the fused update over
    int8 pools; the unified ragged view) match JAX's ``ref`` within 1e-5
    on live rows, pools and scale pools bit-equal on every page but the
    null page (the JAX oracle dumps padded rows there), and one int8 case
    matches the Pallas kernel in interpret mode;
  * ``copy_page`` is bit-equal to JAX's on fp32, bf16, int8 and scale
    pools;
  * ``paged_step`` and ``unified_step`` on an int8 cache match JAX's;
  * the engine with ``kv_dtype="int8"`` finishes every request, keeps the
    JAX engine's capacity ledger, and serves the JAX int8 engine's greedy
    streams.  K and V can differ by an ulp across the frameworks and land
    on the other side of a rounding tie, so a divergence there is logged
    with generate's top-2 logit margin, not failed.

The CUDA kernels themselves are tested on the card by ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduced as jax_reduced
from repro.kernels.paged_attention import ref as jax_ref
from repro.models import model as JM
from repro_torch.config import get_config, reduced
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.weights import params_from_numpy

FULL = 1 << 30
RTOL = 1e-5
BRANCH_GAIN = 8.0        # see test_torch_paged_serving


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_case(seed, *, S, filled, ns, Hkv, G, BS, MB, D=16):
    """Random int8 pools (garbage everywhere) with fp32 scale pools, fresh
    fp32 rows and tables for one step: filled[b] cached tokens and ns[b]
    fresh ones in row b (0 = padded row, null table)."""
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
    pool = lambda: rng.integers(-127, 128, (NB, BS, Hkv, D)).astype(np.int8)  # noqa: E731
    scale = lambda: np.abs(rng.standard_normal((NB, BS, Hkv))).astype(  # noqa: E731
        np.float32)
    return dict(q=arr(B, S, Hkv * G, D), kn=arr(B, S, Hkv, D),
                vn=arr(B, S, Hkv, D), kp=pool(), vp=pool(), ks=scale(),
                vs=scale(), tables=tables, pos=pos,
                live=int(pos.max()) // BS + 1 if (pos >= 0).any() else 1)


def _t(c, *names):
    return [torch.from_numpy(np.array(c[n])) for n in names]


def _j(c, *names):
    return [jnp.asarray(c[n]) for n in names]


def jax_update(c, *, window, softcap):
    kp, vp, ks, vs = jax_ref.write_kv(*_j(c, "kp", "vp", "kn", "vn", "pos",
                                          "tables", "ks", "vs"))
    out = jax_ref.paged_attention(
        *_j(c, "q"), kp, vp, *_j(c, "tables", "pos"),
        window=jnp.asarray(window, jnp.int32), softcap=softcap,
        max_live_blocks=c["live"], k_scale=ks, v_scale=vs)
    return tuple(np.asarray(a) for a in (out, kp, vp, ks, vs))


def torch_update(c, *, window, softcap, fn=pa_ops.paged_attention_update):
    q, kn, vn, kp, vp, ks, vs, tables, pos = _t(
        c, "q", "kn", "vn", "kp", "vp", "ks", "vs", "tables", "pos")
    res = fn(q, kn, vn, kp, vp, tables, pos, window=window, softcap=softcap,
             max_live_blocks=c["live"], k_scale=ks, v_scale=vs)
    assert res[1] is kp and res[3] is ks          # updated in place
    return tuple(a.numpy() for a in res)


def assert_parity(live, got, want, rtol=RTOL):
    """Outputs within ``rtol`` on live rows; every pool bit-equal on every
    page but the null page."""
    out_g, out_w = got[0][live], want[0][live]
    np.testing.assert_allclose(out_g, out_w, rtol=rtol,
                               atol=rtol * np.abs(out_w).max())
    assert np.isfinite(got[0]).all()
    for pg, pw in zip(got[1:], want[1:]):
        assert pg.dtype == pw.dtype
        np.testing.assert_array_equal(pg[1:], pw[1:])


# --- the quantization recipe -------------------------------------------------

def test_quantize_rows_bit_equal_to_jax():
    """int8 values and fp32 scales bit-equal to JAX's, on random rows, an
    all-zero row (scale 0, zeros) and rows of exact .5 ties (amax 127
    makes the scale 1, so x * inv lands on k + 0.5: half to even)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((40, 3, 16)) * 3).astype(np.float32)
    x[2] = 0.0
    x[5, 0] = np.arange(16) - 7.5
    x[5, 0, 0] = 127.0
    x[6, 1] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5,
               126.5, -126.5, 0, 0, 0, 0, 0, 127]
    qj, sj = jax_ref.quantize_rows(jnp.asarray(x))
    qt, st = pa_ref.quantize_rows(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.int32),
                                  np.asarray(sj).view(np.int32))
    assert st[6, 1].item() == 1.0
    assert qt[6, 1, :10].tolist() == [0, 2, 2, 0, -2, -2, 4, -4, 126, -126]
    assert not qt[2].any() and not st[2].any()
    back = pa_ref.dequantize(qt, st)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jax_ref.dequantize(qj, sj)))


def test_write_kv_int8_bit_equal_to_jax():
    """The int8 scatter: pools and scale pools bit-equal to JAX's on every
    page but the null page, which the port leaves as it was."""
    c = make_case(1, S=3, filled=[2, 5, 0], ns=[3, 1, 0], Hkv=2, G=2,
                  BS=4, MB=3)
    want = jax_ref.write_kv(*_j(c, "kp", "vp", "kn", "vn", "pos", "tables",
                                "ks", "vs"))
    kp, vp, ks, vs, kn, vn, pos, tables = _t(
        c, "kp", "vp", "ks", "vs", "kn", "vn", "pos", "tables")
    got = pa_ref.write_kv(kp, vp, kn, vn, pos, tables, ks, vs)
    assert got[0] is kp and got[2] is ks
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[1:], np.asarray(w)[1:])
    for g, name in zip(got, ("kp", "vp", "ks", "vs")):
        np.testing.assert_array_equal(g.numpy()[0], c[name][0])


# --- the walks ---------------------------------------------------------------

@pytest.mark.parametrize("Hkv,G", [(1, 4), (2, 2), (4, 1)])
def test_int8_decode_parity_ragged_gqa(Hkv, G):
    c = make_case(10 + G, S=1, filled=[0, 7, 21, 0], ns=[1, 1, 1, 0],
                  Hkv=Hkv, G=G, BS=4, MB=8)
    assert_parity(c["pos"] >= 0, torch_update(c, window=FULL, softcap=0.0),
                  jax_update(c, window=FULL, softcap=0.0))


@pytest.mark.parametrize("window,softcap", [(6, 0.0), (FULL, 30.0)])
def test_int8_window_softcap_parity(window, softcap):
    c = make_case(3, S=1, filled=[13, 3, 29], ns=[1, 1, 1], Hkv=2, G=2,
                  BS=4, MB=10)
    assert_parity(c["pos"] >= 0,
                  torch_update(c, window=window, softcap=softcap),
                  jax_update(c, window=window, softcap=softcap))


def test_int8_chunked_prefill_parity():
    """S > 1: every fresh row quantizes into its slot with its own scale;
    page-crossing chunks land rows on both pages."""
    c = make_case(9, S=4, filled=[5, 0, 9], ns=[4, 4, 2], Hkv=2, G=2, BS=4,
                  MB=10)
    assert_parity(c["pos"] >= 0, torch_update(c, window=FULL, softcap=0.0),
                  jax_update(c, window=FULL, softcap=0.0))


def test_int8_unified_ragged_parity():
    """The unified ragged view over int8 pools (decode rows and prefill
    segments, walked per request through row_map) against JAX's flat
    scatter-first oracle; scale pools bit-equal."""
    rng = np.random.default_rng(50)
    segments, Hkv, G, BS, MB, D = [(9, 1), (0, 4), (25, 5), (13, 1)], 2, 2, \
        4, 9, 16
    real = sum(n for _, n in segments)
    T, chm = real + 2, max(n for _, n in segments)
    pos = np.full((T, 1), -1, np.int32)
    tables = np.zeros((T, MB), np.int32)
    req_tables = np.zeros((len(segments), MB), np.int32)
    row_map = np.full((len(segments), chm), real, np.int32)
    r, page = 0, 1
    for i, (f, n) in enumerate(segments):
        nblk = (f + n - 1) // BS + 1
        req_tables[i, :nblk] = np.arange(page, page + nblk)
        page += nblk
        pos[r:r + n, 0] = f + np.arange(n)
        tables[r:r + n] = req_tables[i]
        row_map[i, :n] = np.arange(r, r + n)
        r += n
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    c = dict(q=f32(T, 1, Hkv * G, D), kn=f32(T, 1, Hkv, D),
             vn=f32(T, 1, Hkv, D),
             kp=rng.integers(-127, 128, (page, BS, Hkv, D)).astype(np.int8),
             vp=rng.integers(-127, 128, (page, BS, Hkv, D)).astype(np.int8),
             ks=np.abs(f32(page, BS, Hkv)), vs=np.abs(f32(page, BS, Hkv)),
             tables=tables, pos=pos, live=int(pos.max()) // BS + 1)
    want = jax_ref.unified_attention_update(
        *_j(c, "q", "kn", "vn", "kp", "vp", "tables", "pos"),
        window=jnp.asarray(FULL, jnp.int32), softcap=0.0,
        max_live_blocks=c["live"], k_scale=jnp.asarray(c["ks"]),
        v_scale=jnp.asarray(c["vs"]))
    q, kn, vn, kp, vp, ks, vs, p = _t(c, "q", "kn", "vn", "kp", "vp", "ks",
                                      "vs", "pos")
    got = pa_ops.paged_attention_unified(
        q, kn, vn, kp, vp, torch.from_numpy(req_tables), p,
        torch.from_numpy(row_map), window=FULL, softcap=0.0,
        max_live_blocks=c["live"], k_scale=ks, v_scale=vs)
    assert len(got) == 5
    assert_parity(pos >= 0, tuple(a.numpy() for a in got),
                  tuple(np.asarray(a) for a in want))


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_readonly_op_matches_reference(quant):
    """The read-only op over already-written pools, fp and int8, against
    JAX's ``ref.paged_attention``; the pools are not written."""
    c = make_case(5, S=1, filled=[9, 25, 2], ns=[1, 1, 1], Hkv=2, G=1,
                  BS=4, MB=10)
    if not quant:
        rng = np.random.default_rng(6)
        c["kp"] = rng.standard_normal(c["kp"].shape).astype(np.float32)
        c["vp"] = rng.standard_normal(c["vp"].shape).astype(np.float32)
    scales = ("ks", "vs") if quant else ()
    want = jax_ref.paged_attention(
        *_j(c, "q", "kp", "vp", "tables", "pos"),
        window=jnp.asarray(FULL, jnp.int32), softcap=0.0,
        max_live_blocks=c["live"],
        **dict(zip(("k_scale", "v_scale"), _j(c, *scales))))
    q, kp, vp, tables, pos = _t(c, "q", "kp", "vp", "tables", "pos")
    before = [kp.clone(), vp.clone()]
    got = pa_ops.paged_attention(
        q, kp, vp, tables, pos, window=FULL, softcap=0.0,
        max_live_blocks=c["live"],
        **dict(zip(("k_scale", "v_scale"), _t(c, *scales))))
    live = c["pos"] >= 0
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=RTOL,
                               atol=RTOL * np.abs(want[live]).max())
    assert torch.equal(kp, before[0]) and torch.equal(vp, before[1])


def test_int8_readonly_matches_pallas_kernel_in_interpret_mode():
    """One int8 read-only case against the TPU kernel itself, run as the
    JAX tests run it on the CPU (Pallas interpret mode)."""
    from repro.kernels.paged_attention.kernel import paged_attention_pallas
    c = make_case(7, S=2, filled=[5, 0], ns=[2, 1], Hkv=1, G=2, BS=4, MB=3)
    want = paged_attention_pallas(
        *_j(c, "q", "kp", "vp", "tables", "pos"),
        window=jnp.asarray(FULL, jnp.int32), softcap=0.0,
        max_live_blocks=c["live"], interpret=True,
        k_scale=jnp.asarray(c["ks"]), v_scale=jnp.asarray(c["vs"]))
    q, kp, vp, ks, vs, tables, pos = _t(c, "q", "kp", "vp", "ks", "vs",
                                        "tables", "pos")
    got = pa_kernel.paged_attention(q, kp, vp, tables, pos, window=FULL,
                                    softcap=0.0, max_live_blocks=c["live"],
                                    k_scale=ks, v_scale=vs)
    live = c["pos"] >= 0
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=RTOL,
                               atol=RTOL * np.abs(want[live]).max())


def test_wrappers_run_plain_versions_on_cpu():
    """CPU tensors take the plain versions and launch nothing: the int8
    update, the read-only walk and copy_page."""
    c = make_case(8, S=2, filled=[3, 1], ns=[2, 1], Hkv=2, G=2, BS=4, MB=3)
    counts = (pa_kernel.launches, pa_kernel.int8_launches,
              pa_kernel.readonly_launches, pa_kernel.copy_launches)
    got = torch_update(c, window=6, softcap=0.0,
                       fn=pa_kernel.paged_attention_update)
    assert_parity(c["pos"] >= 0, got, torch_update(
        c, window=6, softcap=0.0, fn=pa_ref.unified_attention_update))
    q, kp, vp, ks, vs, tables, pos = _t(c, "q", "kp", "vp", "ks", "vs",
                                        "tables", "pos")
    pa_kernel.paged_attention(q, kp, vp, tables, pos, window=6, softcap=0.0,
                              max_live_blocks=c["live"], k_scale=ks,
                              v_scale=vs)
    pa_kernel.copy_page(kp[None], 1, 2)
    assert counts == (pa_kernel.launches, pa_kernel.int8_launches,
                      pa_kernel.readonly_launches, pa_kernel.copy_launches)


@pytest.mark.parametrize("bad,err", [
    ("pool_dtype", TypeError), ("scale_dtype", TypeError),
    ("scale_shape", TypeError), ("one_scale", ValueError),
    ("new_dtype", TypeError)])
def test_kernel_wrapper_checks_int8(bad, err):
    """What the CUDA wrapper refuses for int8 pools before any launch (the
    checks run on any device)."""
    B, S, H, Hkv, D, NB, BS, MB = 2, 1, 4, 2, 16, 5, 4, 2
    q = torch.zeros(B, S, H, D)
    kn = torch.zeros(B, S, Hkv, D)
    pool = torch.zeros(NB, BS, Hkv, D, dtype=torch.int8)
    scale = torch.zeros(NB, BS, Hkv)
    vscale = scale
    tables = torch.zeros(B, MB, dtype=torch.int32)
    pos = torch.zeros(B, S, dtype=torch.int32)
    if bad == "pool_dtype":
        pool = pool.float()
    elif bad == "scale_dtype":
        scale = vscale = scale.double()
    elif bad == "scale_shape":
        scale = vscale = torch.zeros(NB, BS, Hkv, 1)
    elif bad == "one_scale":
        scale = None
    elif bad == "new_dtype":
        kn = kn.to(torch.int8)
    with pytest.raises(err):
        pa_kernel._check(q, kn, kn, pool, pool, tables, pos, k_scale=scale,
                         v_scale=vscale)
    pa_kernel._check(q, None, None, torch.zeros(NB, BS, Hkv, D), torch.zeros(
        NB, BS, Hkv, D), tables, pos)                 # the fp read-only walk


# --- copy_page ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8",
                                   "scale"])
def test_copy_page_parity(dtype):
    """copy_page on a stacked (L, NB, ...) pool is bit-equal to JAX's: the
    destination carries the source's rows in every layer, the source and
    every other page are untouched (the ports of test_copy_page_parity and
    test_int8_copy_page_carries_scales)."""
    rng = np.random.default_rng(11)
    L, NB, BS, Hkv, D = 3, 6, 4, 2, 8
    if dtype == "int8":
        pool = rng.integers(-127, 128, (L, NB, BS, Hkv, D)).astype(np.int8)
    elif dtype == "scale":
        pool = np.abs(rng.standard_normal((L, NB, BS, Hkv))).astype(
            np.float32)
    else:
        pool = rng.standard_normal((L, NB, BS, Hkv, D)).astype(np.float32)
    jpool = jnp.asarray(pool)
    tpool = torch.from_numpy(pool.copy())
    if dtype == "bfloat16":
        jpool, tpool = jpool.astype(jnp.bfloat16), tpool.to(torch.bfloat16)
    src, dst = 2, 5
    want = jax_ref.copy_page(jpool, src, dst)
    before = tpool.clone()
    got = pa_ops.copy_page(tpool, src, dst)
    assert got is tpool                                # in place
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert torch.equal(got[:, dst], before[:, src])
    keep = [p for p in range(NB) if p != dst]
    assert torch.equal(got[:, keep], before[:, keep])
    # the ids as one int32 tensor {src, dst}, as the device path takes them
    again = pa_ops.copy_page(before.clone(), torch.tensor([src, dst],
                                                          dtype=torch.int32))
    assert torch.equal(again, got)


@pytest.mark.parametrize("src,dst", [(3, 3), (-1, 2), (1, 6)])
def test_copy_page_rejects_bad_host_ids(src, dst):
    pool = torch.zeros(2, 6, 4, 1, 8)
    with pytest.raises(ValueError):
        pa_ops.copy_page(pool, src, dst)
    with pytest.raises(ValueError):
        pa_ops.copy_page(pool, torch.tensor([src, dst], dtype=torch.int32))


# --- the step on an int8 cache -----------------------------------------------

def _bridged(seed):
    jcfg = jax_reduced(jax_get_config("granite-3-2b"))
    cfg = reduced(get_config("granite-3-2b"))
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(seed)))
    for k in ("attn", "mlp"):
        tree["layers"][k]["wo"] = tree["layers"][k]["wo"] * BRANCH_GAIN
    return (jcfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_numpy(tree, cfg, device="cpu"))


def test_paged_and_unified_step_int8_match_jax():
    """``paged_step`` (a prefill chunk with a padded tail) then
    ``unified_step`` (a decode row beside a prefill segment) on an int8
    cache, on bridged weights: logits within 1e-4 relative, int8 pools and
    scale pools equal to JAX's on every page but the null page, up to
    a rounding tie that an ulp of K or V moves across (at most 2 rows)."""
    from repro.serving import paged_attn as jax_pa
    from repro_torch.serving import paged_attn as pa
    jcfg, jparams, cfg, params = _bridged(1)
    jcache = jax_pa.init_paged_cache(jcfg, 9, 4, kv_dtype="int8")
    cache = pa.init_paged_cache(cfg, 9, 4, device="cpu", kv_dtype="int8")
    assert set(cache) == set(jcache)
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape
    assert cache["k"].dtype == torch.int8
    assert cache["k_scale"].dtype == torch.float32
    rng = np.random.default_rng(12)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)
    toks = rng.integers(0, cfg.vocab, (2, 5)).astype(np.int32)
    pos = np.array([[0, 1, 2, 3, 4], [0, 1, 2, -1, -1]], np.int32)

    def close(got, want, live):
        want = np.asarray(want)[live][..., :cfg.vocab]
        np.testing.assert_allclose(got.numpy()[live][..., :cfg.vocab], want,
                                   rtol=1e-4, atol=1e-4 * np.abs(want).max())

    jl, jcache = jax_pa.paged_step(jcfg, jparams, jcache,
                                   *(jnp.asarray(a) for a in
                                     (toks, pos, tables)),
                                   max_live_blocks=2)
    with torch.no_grad():
        tl, cache = pa.paged_step(cfg, params, cache, torch.from_numpy(toks),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(tables), max_live_blocks=2)
    close(tl, jl, pos >= 0)
    flat_tok = np.array([7, toks[1, 3], toks[1, 4], 0], np.int32)
    flat_pos = np.array([5, 3, 4, -1], np.int32)
    row_map = np.array([[0, 3], [1, 2]], np.int32)
    verify = np.array([[0], [2]], np.int32)
    args = (flat_tok, flat_pos, tables, row_map, verify)
    jl, jcache = jax_pa.unified_step(jcfg, jparams, jcache,
                                     *(jnp.asarray(a) for a in args),
                                     max_live_blocks=2, max_seg_len=2)
    with torch.no_grad():
        tl, cache = pa.unified_step(cfg, params, cache,
                                    *(torch.from_numpy(a) for a in args),
                                    max_live_blocks=2, max_seg_len=2)
    close(tl, jl, np.ones((2, 1), bool))
    for name in ("k", "v"):
        got = cache[name].numpy()[:, 1:].astype(np.int32)
        want = np.asarray(jcache[name])[:, 1:].astype(np.int32)
        # a row whose fp32 K or V moved by an ulp may round one value to
        # the neighbouring int8 level; no more than that
        assert np.abs(got - want).max() <= 1
        assert (got != want).any(axis=-1).sum() <= 2
        np.testing.assert_allclose(cache[name + "_scale"].numpy()[:, 1:],
                                   np.asarray(jcache[name + "_scale"])[:, 1:],
                                   rtol=1e-5)


# --- the engine --------------------------------------------------------------

def test_int8_engine_finishes_and_keeps_the_capacity_ledger():
    """Every request finishes with its tokens; the allocator's ledger is
    JAX's (the port of test_int8_capacity_ledger): an int8 page costs
    2·L·BS·Hkv·(D+4) bytes beside the fp baseline, at most half of it for
    fp32 models."""
    from repro.serving import PagedServingEngine as JaxEngine
    from repro_torch.serving import PagedServingEngine
    jcfg, jparams, cfg, params = _bridged(0)
    kw = dict(max_slots=3, block_size=4, max_blocks_per_seq=10,
              num_blocks=13)
    eng8 = PagedServingEngine(cfg, params, kv_dtype="int8", device="cpu",
                              **kw)
    engf = PagedServingEngine(cfg, params, device="cpu", **kw)
    u8, uf = eng8.alloc.utilization(), engf.alloc.utilization()
    j8 = JaxEngine(jcfg, jparams, kv_dtype="int8", **kw).alloc.utilization()
    assert u8 == j8
    assert u8["kv_dtype"] == "int8" and uf["kv_dtype"] == "fp"
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    assert u8["page_bytes_per_shard"] == 2 * L * 4 * Hkv * (D + 4)
    assert u8["fp_page_bytes_per_shard"] == uf["page_bytes_per_shard"]
    assert u8["quantized_bytes_ratio"] <= 0.5
    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, cfg.vocab, n).astype(np.int32)
               for n in (9, 14, 11, 12)]
    ids = [eng8.submit(p, 8) for p in prompts]
    out = eng8.run_to_completion()
    assert all(len(out[i]) == 8 for i in ids)
    assert eng8.metrics()["kv_dtype"] == "int8"
    assert eng8.metrics()["scheduler"]["preemptions"] >= 1
    assert eng8.alloc.utilization()["in_use"] == 0


def test_int8_engine_streams_against_jax(capsys):
    """Greedy streams of the port's int8 engine against the JAX int8
    engine's, on bridged weights.  A divergence does not fail: the two
    frameworks' K/V can differ by an ulp and round to another int8 level.
    It is logged with the top-2 logit margin of the port's ``generate``
    (fp pages) at that token, and most streams must agree."""
    from repro.serving import PagedServingEngine as JaxEngine
    from repro_torch.launch.serve import generate
    from repro_torch.serving import PagedServingEngine
    jcfg, jparams, cfg, params = _bridged(0)
    kw = dict(max_slots=2, block_size=4, max_blocks_per_seq=8,
              prefill_chunk=3, token_budget=5, kv_dtype="int8")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (7, 4, 9, 5)]
    gens = [6, 8, 5, 6]
    outs = []
    for eng in (JaxEngine(jcfg, jparams, **kw),
                PagedServingEngine(cfg, params, device="cpu", **kw)):
        ids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
        res = eng.run_to_completion()
        outs.append([res[i] for i in ids])
    same = 0
    for p, g, want, got in zip(prompts, gens, *outs):
        assert len(got) == g
        t = next((i for i in range(g) if got[i] != want[i]), None)
        if t is None:
            same += 1
            continue
        _, top2 = generate(cfg, params, torch.from_numpy(p)[None], g,
                           return_top2=True)
        print(f"int8 stream diverges from JAX's at token {t}: top-2 logit "
              f"margin {(top2[0, t, 0] - top2[0, t, 1]).item():.4f}")
    assert same >= len(prompts) - 1
    assert len({t for s in outs[1] for t in s}) > 3
