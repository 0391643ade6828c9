"""The copy-on-write over a whole cache (``copy_pages``) and the paged walk
at head_dim 128, in the port, against the JAX package on the CPU.

  * ``ops.copy_pages`` over a {K, V} set (fp32, bf16) and over an int8
    {K, V, K-scale, V-scale} set is bit-equal to JAX's ``ref.copy_page``
    applied to each pool, with host ids and with an int32 id tensor; bad
    ids raise and leave every pool as it was; pool sets the kernel cannot
    take in one launch (L or NB differing, more than ``MAX_POOLS``) raise
    on any device, before a launch;
  * the walk's wrapper admits head_dim 128 (glm4-9b, olmoe-1b-7b and
    grok-1-314b use it), and the port's plain update and read-only walk at
    D 128 and glm4-9b's GQA ratio (G 16) match JAX's reference walk, fp32
    and int8 pools.

The CUDA kernels themselves are tested on the card by ``test_torch_cuda.py``.
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
# D 128 walks: fp32 sums over 128-wide dots and a softmax over up to 40
# keys in another order than JAX's; the other walk tests' 1e-5 holds
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cache_set(kind, seed=0, L=3, NB=6, BS=4, Hkv=2, D=8):
    """A cache's pools as numpy arrays: {K, V} of fp32 (or bf16 once on
    each side), or int8 {K, V} with their fp32 scale pools."""
    rng = np.random.default_rng(seed)
    if kind == "int8":
        q = lambda: rng.integers(-127, 128, (L, NB, BS, Hkv, D)).astype(  # noqa: E731
            np.int8)
        s = lambda: np.abs(rng.standard_normal((L, NB, BS, Hkv))).astype(  # noqa: E731
            np.float32)
        return [q(), q(), s(), s()]
    return [rng.standard_normal((L, NB, BS, Hkv, D)).astype(np.float32)
            for _ in range(2)]


def _pair(kind, arrays):
    """The same pools for JAX and for the port."""
    jp = [jnp.asarray(a) for a in arrays]
    tp = [torch.from_numpy(a.copy()) for a in arrays]
    if kind == "bfloat16":
        jp = [a.astype(jnp.bfloat16) for a in jp]
        tp = [t.to(torch.bfloat16) for t in tp]
    return jp, tp


@pytest.mark.parametrize("ids", ["host", "tensor"])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_copy_pages_bit_equal_to_jax(kind, ids):
    """Every pool of the set equals JAX's ``ref.copy_page`` of that pool:
    the destination carries the source in every layer, every other page
    is untouched, in place, in the set's order."""
    jp, tp = _pair(kind, cache_set(kind, seed=1))
    src, dst = 4, 1
    before = [t.clone() for t in tp]
    arg = ((src, dst) if ids == "host"
           else (torch.tensor([src, dst], dtype=torch.int32),))
    got = pa_ops.copy_pages(tp, *arg)
    assert len(got) == len(tp) and all(g is t for g, t in zip(got, tp))
    for g, j, b in zip(got, jp, before):
        want = jax_ref.copy_page(j, src, dst)
        assert g.dtype == b.dtype
        np.testing.assert_array_equal(
            g.float().numpy() if kind == "bfloat16" else g.numpy(),
            np.asarray(want.astype(jnp.float32) if kind == "bfloat16"
                       else want))
        keep = [p for p in range(b.shape[1]) if p != dst]
        assert torch.equal(g[:, dst], b[:, src])
        assert torch.equal(g[:, keep], b[:, keep])


def test_copy_pages_equals_copy_page_on_each_pool():
    """One call over the set leaves the same bytes as ``copy_page`` on
    each pool in turn (the plain version, ``ref.copy_pages``, too)."""
    arrays = cache_set("int8", seed=2)
    a = [torch.from_numpy(x.copy()) for x in arrays]
    b = [torch.from_numpy(x.copy()) for x in arrays]
    c = [torch.from_numpy(x.copy()) for x in arrays]
    pa_ops.copy_pages(a, 5, 0)
    for pool in b:
        pa_ops.copy_page(pool, 5, 0)
    pa_ref.copy_pages(c, 5, 0)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.parametrize("src,dst", [(3, 3), (-1, 2), (1, 6), (6, 0)])
def test_copy_pages_bad_ids_raise_and_move_nothing(src, dst):
    """src == dst or an id outside [0, NB): ValueError for host ids and
    for an id tensor, and no pool of the set changes."""
    pools = [torch.from_numpy(x) for x in cache_set("int8", seed=3)]
    before = [p.clone() for p in pools]
    with pytest.raises(ValueError):
        pa_ops.copy_pages(pools, src, dst)
    with pytest.raises(ValueError):
        pa_ops.copy_pages(pools, torch.tensor([src, dst], dtype=torch.int32))
    assert all(torch.equal(p, b) for p, b in zip(pools, before))


@pytest.mark.parametrize("case", ["L", "NB", "five", "none", "ids"])
def test_copy_pages_refuses_sets_before_a_launch(case):
    """What ``kernel.copy_pages`` refuses on any device, before it reaches
    a kernel: pools that differ in L or in NB, more than ``MAX_POOLS``
    pools or none, and ids that are neither two ints nor an int32 pair."""
    pools = [torch.zeros(2, 5, 4, 1, 8), torch.zeros(2, 5, 4, 1)]
    err = ValueError
    if case == "L":
        pools.append(torch.zeros(3, 5, 4, 1))
    elif case == "NB":
        pools.append(torch.zeros(2, 6, 4, 1))
    elif case == "five":
        pools = pools * 2 + [torch.zeros(2, 5, 3)]
        assert len(pools) == pa_kernel.MAX_POOLS + 1
    elif case == "none":
        pools = []
    else:
        err = TypeError
    with pytest.raises(err):
        if case == "ids":
            pa_kernel.copy_pages(pools, torch.tensor([1, 2]))
        else:
            pa_kernel.copy_pages(pools, 1, 2)


def test_copy_pages_launches_nothing_on_cpu():
    """CPU tensors take the plain version: no launch is counted."""
    n = pa_kernel.copy_launches
    pa_kernel.copy_pages([torch.zeros(2, 4, 3), torch.ones(2, 4, 5)], 0, 3)
    pa_kernel.copy_page(torch.zeros(2, 4, 3), 1, 2)
    assert pa_kernel.copy_launches == n


# --- the walk at head_dim 128 ---------------------------------------------

def test_walk_check_admits_head_dim_128():
    """The wrapper's checks take D 128 for the fused update and the
    read-only walk, fp and int8 pools (it still refuses head_dim 8:
    ``test_kernel_wrapper_checks[head_dim]``)."""
    assert 128 in pa_kernel.HEAD_DIMS
    B, S, H, Hkv, D, NB, BS, MB = 2, 1, 32, 2, 128, 5, 16, 2
    q = torch.zeros(B, S, H, D)
    kn = torch.zeros(B, S, Hkv, D)
    tables = torch.zeros(B, MB, dtype=torch.int32)
    pos = torch.zeros(B, S, dtype=torch.int32)
    fp = torch.zeros(NB, BS, Hkv, D)
    i8 = torch.zeros(NB, BS, Hkv, D, dtype=torch.int8)
    sc = torch.zeros(NB, BS, Hkv)
    for new in (kn, None):
        pa_kernel._check(q, new, new, fp, fp, tables, pos)
        pa_kernel._check(q, new, new, i8, i8, tables, pos, k_scale=sc,
                         v_scale=sc)
    with pytest.raises(ValueError):
        pa_kernel._check(q[..., :8].contiguous(), None, None,
                         fp[..., :8].contiguous(), fp[..., :8].contiguous(),
                         tables, pos)


def d128_case(seed, *, S, filled, ns, Hkv, G, BS, MB, quant):
    """Pools, fresh rows and tables at D 128: int8 pools hold rows quantized
    by the one recipe (as the engine fills them), fp32 pools random."""
    D = 128
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
    c = dict(q=arr(B, S, Hkv * G, D), kn=arr(B, S, Hkv, D),
             vn=arr(B, S, Hkv, D), kp=arr(NB, BS, Hkv, D),
             vp=arr(NB, BS, Hkv, D), tables=tables, pos=pos,
             live=int(pos.max()) // BS + 1)
    if quant:
        for name, sname in (("kp", "ks"), ("vp", "vs")):
            qv, sv = pa_ref.quantize_rows(torch.from_numpy(c[name]))
            c[name], c[sname] = qv.numpy(), sv.numpy()
    return c


# (S, filled, ns, Hkv, BS, MB, window, softcap): glm4-9b decode (G 16,
# several pages a request), a prefill chunk crossing pages, softcap 30
D128_CASES = {
    "glm4_decode": (1, [40, 7, 21, 0], [1, 1, 1, 0], 1, 16, 4, FULL, 0.0),
    "chunk_crossing_pages": (5, [13, 0], [5, 3], 1, 4, 6, FULL, 0.0),
    "softcap_window": (2, [30, 9], [2, 1], 1, 8, 5, 12, 30.0),
}


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("case", list(D128_CASES))
def test_d128_walks_match_jax(case, quant):
    """The port's plain fused update and read-only walk at D 128, G 16
    (glm4-9b's 32 heads over 2 kv heads, one kv head kept), against JAX's
    ``ref.write_kv`` + ``ref.paged_attention``: live rows within
    ``RTOL``; the update's pools (and scale pools) bit-equal on every page
    but the null page."""
    S, filled, ns, Hkv, BS, MB, window, softcap = D128_CASES[case]
    c = d128_case(len(case) + quant, S=S, filled=filled, ns=ns, Hkv=Hkv,
                  G=16, BS=BS, MB=MB, quant=quant)
    live = c["pos"] >= 0
    names = ["kp", "vp"] + (["ks", "vs"] if quant else [])
    j = {k: jnp.asarray(v) for k, v in c.items() if k != "live"}
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()
         if k != "live"}
    scales = dict(k_scale=j["ks"], v_scale=j["vs"]) if quant else {}
    tscales = dict(k_scale=t["ks"], v_scale=t["vs"]) if quant else {}
    walk = dict(window=window, softcap=softcap, max_live_blocks=c["live"])
    jwin = dict(walk, window=jnp.asarray(window, jnp.int32))
    # read-only, over the pools as they are
    want = np.asarray(jax_ref.paged_attention(
        j["q"], j["kp"], j["vp"], j["tables"], j["pos"], **jwin, **scales))
    got = pa_ops.paged_attention(t["q"], t["kp"], t["vp"], t["tables"],
                                 t["pos"], **walk, **tscales).numpy()
    np.testing.assert_allclose(got[live], want[live], rtol=RTOL,
                               atol=RTOL * np.abs(want[live]).max())
    # the fused update
    jscales = (j["ks"], j["vs"]) if quant else ()
    pools = jax_ref.write_kv(j["kp"], j["vp"], j["kn"], j["vn"], j["pos"],
                             j["tables"], *jscales)
    jsc = dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}
    want = np.asarray(jax_ref.paged_attention(
        j["q"], pools[0], pools[1], j["tables"], j["pos"], **jwin, **jsc))
    res = pa_ops.paged_attention_update(
        t["q"], t["kn"], t["vn"], t["kp"], t["vp"], t["tables"], t["pos"],
        **walk, **tscales)
    got = res[0].numpy()
    np.testing.assert_allclose(got[live], want[live], rtol=RTOL,
                               atol=RTOL * np.abs(want[live]).max())
    assert np.isfinite(got).all()
    assert len(res) == 1 + len(names)
    for g, w in zip(res[1:], pools):
        np.testing.assert_array_equal(g.numpy()[1:], np.asarray(w)[1:])
