"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false (the kernels have no CPU mode).  The
file imports neither JAX nor ``repro``, so it runs on a GPU machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention import ref as pa_ref

FULL = 1 << 30

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def make_case(seed, *, S, filled, ns, Hkv, G, BS, MB, D):
    """Random pools/tables for one step: filled[b] cached tokens and ns[b]
    fresh ones in row b (0 = padded row); pages distinct per request."""
    rng = np.random.default_rng(seed)
    B = len(filled)
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
    NB = 1 + B * MB
    return dict(q=arr(B, S, Hkv * G, D), kn=arr(B, S, Hkv, D),
                vn=arr(B, S, Hkv, D), kp=arr(NB, BS, Hkv, D),
                vp=arr(NB, BS, Hkv, D), tables=tables, pos=pos,
                live=int(pos.max()) // BS + 1)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _on(dev, c, dtype):
    t = {k: torch.from_numpy(np.array(c[k])).to(dev)
         for k in ("q", "kn", "vn", "kp", "vp", "tables", "pos")}
    for k in ("q", "kn", "vn", "kp", "vp"):
        t[k] = t[k].to(dtype)
    return t


@pytest.mark.parametrize("dtype,D,G,tol", [
    (torch.float32, 16, 2, 1e-4), (torch.float32, 64, 4, 1e-4),
    (torch.bfloat16, 256, 8, 3e-2), (torch.bfloat16, 64, 4, 3e-2)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, D, G, tol):
    """Live-row outputs within ``tol`` and pools bit-equal, for a prefill
    chunk crossing pages plus decode and idle rows, with and without a
    window and softcap.  fp32: summation order.  bf16: the kernel rounds
    the unnormalised p = exp(s - m) to bf16 and divides by l at the end,
    the plain version rounds the normalised softmax, and both round the
    output to bf16.  A kernel that skips the scatter (the fresh rows read
    as stale page rows) must land outside ``tol``."""
    c = make_case(8, S=16, filled=[10, 21, 5, 0], ns=[16, 1, 9, 0],
                  Hkv=2, G=G, BS=16, MB=4, D=D)
    t = _on(cuda_device, c, dtype)
    for window, softcap in ((FULL, 0.0), (12, 20.0)):
        res = {}
        for name, fn in (("plain", pa_ref.unified_attention_update),
                         ("kernel", pa_kernel.paged_attention_update)):
            res[name] = fn(t["q"], t["kn"], t["vn"], t["kp"].clone(),
                           t["vp"].clone(), t["tables"], t["pos"],
                           window=window, softcap=softcap,
                           max_live_blocks=c["live"])
        torch.cuda.synchronize()
        live = torch.from_numpy(c["pos"] >= 0).to(cuda_device)
        err = (res["kernel"][0].float() - res["plain"][0].float())[live]
        assert err.abs().max().item() <= tol
        stale = pa_ref.paged_attention(
            t["q"], t["kp"], t["vp"], t["tables"], t["pos"], window=window,
            softcap=softcap, max_live_blocks=c["live"])
        wrong = (stale.float() - res["plain"][0].float())[live]
        assert wrong.abs().max().item() > tol
        assert torch.isfinite(res["kernel"][0].float()).all()
        for i in (1, 2):
            assert torch.equal(res["kernel"][i][1:], res["plain"][i][1:])


def test_cuda_kernel_counts_launches(cuda_device):
    c = make_case(9, S=1, filled=[3], ns=[1], Hkv=1, G=2, BS=4, MB=2, D=16)
    t = _on(cuda_device, c, torch.float32)
    before = pa_kernel.launches
    pa_kernel.paged_attention_update(
        t["q"], t["kn"], t["vn"], t["kp"], t["vp"], t["tables"], t["pos"],
        window=FULL, softcap=0.0, max_live_blocks=1)
    assert pa_kernel.launches == before + 1


def test_cuda_engine_token_exact(cuda_device):
    """The paged engine on the card (reduced granite-3-2b, fp32) serves
    exactly ``generate``'s tokens, one kernel launch per layer per tick.
    Output projections are scaled by 8 so that attention, not the token
    embedding, decides each greedy token (see test_torch_paged_serving);
    the weights are drawn on the CPU, where these prompts' smallest
    top-2 logit gap is 0.13, far above fp32 noise."""
    from repro_torch.config import get_config, reduced
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.serving import PagedServingEngine
    cfg = reduced(get_config("granite-3-2b"))
    params = M.init_params(cfg, seed=0, device="cpu")
    for k in ("attn", "mlp"):
        params["layers"][k]["wo"] *= 8.0
    params = _to(params, cuda_device)
    eng = PagedServingEngine(cfg, params, max_slots=2, block_size=4,
                             max_blocks_per_seq=8, prefill_chunk=3,
                             token_budget=5, device=cuda_device)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (7, 2, 10)]
    before = pa_kernel.launches
    ids = [eng.submit(p, 6) for p in prompts]
    results = eng.run_to_completion()
    assert pa_kernel.launches - before == cfg.n_layers * eng.dispatches
    for rid, p in zip(ids, prompts):
        ref = generate(cfg, params, torch.from_numpy(p)[None].to(cuda_device),
                       6)
        assert results[rid] == ref[0, len(p):].tolist()


# --- int8 pools, the read-only walk, copy_page -------------------------------

def _int8_pools(dev, c, seed):
    """int8 pools with their fp32 scale pools, of the case's shape, on
    ``dev``: random normal rows quantized by ``ref.quantize_rows``, as
    the engine fills them (raw int8 garbage under |normal| scales gives
    scores in the hundreds, a one-hot softmax, and compares nothing but
    near-ties)."""
    g = np.random.default_rng(seed)
    shape = np.array(c["kp"]).shape
    kq, ks = pa_ref.quantize_rows(torch.from_numpy(
        g.standard_normal(shape).astype(np.float32)))
    vq, vs = pa_ref.quantize_rows(torch.from_numpy(
        g.standard_normal(shape).astype(np.float32)))
    return kq.to(dev), vq.to(dev), ks.to(dev), vs.to(dev)


@pytest.mark.parametrize("dtype,D,G,tol", [
    (torch.float32, 16, 2, 1e-4), (torch.float32, 64, 4, 1e-4),
    (torch.bfloat16, 256, 8, 3e-2), (torch.bfloat16, 64, 4, 3e-2)])
def test_cuda_int8_update_matches_plain(cuda_device, dtype, D, G, tol):
    """The fused update over int8 pools: the K/V pools and the scale pools
    bit-equal to the plain version's (both quantize with
    ``ref.quantize_rows``), live-row outputs within ``tol`` (the plain
    version rounds the dequantized pages and p to q's dtype, the kernel
    keeps them in fp32).  Two known-wrong readings land outside ``tol``: a
    walk that skips the scales, and one that skips the scatter."""
    c = make_case(18, S=16, filled=[10, 21, 5, 0], ns=[16, 1, 9, 0],
                  Hkv=2, G=G, BS=16, MB=4, D=D)
    t = _on(cuda_device, c, dtype)
    kp, vp, ks, vs = _int8_pools(cuda_device, c, D + G)
    live = torch.from_numpy(c["pos"] >= 0).to(cuda_device)
    for window, softcap in ((FULL, 0.0), (12, 20.0)):
        res = {}
        for name, fn in (("plain", pa_ref.unified_attention_update),
                         ("kernel", pa_kernel.paged_attention_update)):
            res[name] = fn(t["q"], t["kn"], t["vn"], kp.clone(), vp.clone(),
                           t["tables"], t["pos"], window=window,
                           softcap=softcap, max_live_blocks=c["live"],
                           k_scale=ks.clone(), v_scale=vs.clone())
        torch.cuda.synchronize()
        want = res["plain"][0].float()
        err = (res["kernel"][0].float() - want)[live].abs().max().item()
        assert err <= tol
        assert torch.isfinite(res["kernel"][0].float()).all()
        for i in (1, 2, 3, 4):
            assert torch.equal(res["kernel"][i][1:], res["plain"][i][1:])
        pk, pv, psk, psv = res["plain"][1:]
        ones = torch.ones_like(psk)
        for wrong in (
                pa_ref.paged_attention(t["q"], pk, pv, t["tables"], t["pos"],
                                       window=window, softcap=softcap,
                                       max_live_blocks=c["live"],
                                       k_scale=ones, v_scale=ones),
                pa_ref.paged_attention(t["q"], kp, vp, t["tables"], t["pos"],
                                       window=window, softcap=softcap,
                                       max_live_blocks=c["live"],
                                       k_scale=ks, v_scale=vs)):
            assert (wrong.float() - want)[live].abs().max().item() > tol


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype,D,G,tol", [
    (torch.float32, 16, 2, 1e-4), (torch.bfloat16, 256, 8, 3e-2)])
def test_cuda_readonly_walk_matches_plain(cuda_device, quant, dtype, D, G,
                                          tol):
    """The read-only walk: live-row outputs within ``tol`` of the plain
    version, the pools' bytes unchanged, one launch counted; dropping the
    last live page lands outside ``tol``."""
    c = make_case(19, S=4, filled=[30, 7, 50, 0], ns=[4, 1, 3, 0], Hkv=1,
                  G=G, BS=16, MB=5, D=D)
    t = _on(cuda_device, c, dtype)
    kw = {}
    kp, vp = t["kp"], t["vp"]
    if quant:
        kp, vp, ks, vs = _int8_pools(cuda_device, c, 3)
        kw = dict(k_scale=ks, v_scale=vs)
    before = [x.clone() for x in (kp, vp, *kw.values())]
    n = pa_kernel.readonly_launches
    got = pa_kernel.paged_attention(t["q"], kp, vp, t["tables"], t["pos"],
                                    window=FULL, softcap=0.0,
                                    max_live_blocks=c["live"], **kw)
    want = pa_ref.paged_attention(t["q"], kp, vp, t["tables"], t["pos"],
                                  window=FULL, softcap=0.0,
                                  max_live_blocks=c["live"], **kw).float()
    dropped = pa_ref.paged_attention(t["q"], kp, vp, t["tables"], t["pos"],
                                     window=FULL, softcap=0.0,
                                     max_live_blocks=c["live"] - 1, **kw)
    torch.cuda.synchronize()
    live = torch.from_numpy(c["pos"] >= 0).to(cuda_device)
    assert (got.float() - want)[live].abs().max().item() <= tol
    assert (dropped.float() - want)[live].abs().max().item() > tol
    assert pa_kernel.readonly_launches == n + 1
    for x, y in zip((kp, vp, *kw.values()), before):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["bfloat16", "int8", "scale", "odd"])
def test_cuda_copy_page_bit_equal(cuda_device, kind):
    """copy_page: page dst equals page src bit for bit in every layer, and
    every other page is untouched, for host ids and for device ids; bf16,
    int8 and fp32 scale pools, and a page of 12 bytes (the narrow-vector
    path)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    shape = {"bfloat16": (4, 7, 16, 2, 64), "int8": (4, 7, 16, 1, 256),
             "scale": (18, 7, 16, 1), "odd": (3, 7, 3, 1)}[kind]
    pool = torch.randn(shape, generator=g, device=cuda_device)
    if kind == "bfloat16":
        pool = pool.to(torch.bfloat16)
    elif kind == "int8":
        pool = (pool * 40).clamp(-127, 127).to(torch.int8)
    for ids in ((2, 5), (torch.tensor([6, 1], dtype=torch.int32,
                                      device=cuda_device),)):
        before = pool.clone()
        n = pa_kernel.copy_launches
        pa_kernel.copy_page(pool, *ids)
        torch.cuda.synchronize()
        src, dst = (ids if len(ids) == 2 else ids[0].tolist())
        assert pa_kernel.copy_launches == n + 1
        assert torch.equal(pool[:, dst], before[:, src])
        keep = [p for p in range(shape[1]) if p != dst]
        assert torch.equal(pool[:, keep], before[:, keep])
    assert pa_kernel.copy_page_errors(cuda_device) == 0


def test_cuda_copy_page_device_ids_checked(cuda_device):
    """Bad device-side ids copy nothing and set the device error flag;
    host ids are checked on the host."""
    pool = torch.randn(2, 4, 8, device=cuda_device)
    before = pool.clone()
    for bad in ([1, 1], [0, 4], [-1, 2]):
        pa_kernel.copy_page(pool, torch.tensor(bad, dtype=torch.int32,
                                               device=cuda_device))
        assert pa_kernel.copy_page_errors(cuda_device) == 1
    assert torch.equal(pool, before)
    assert pa_kernel.copy_page_errors(cuda_device) == 0
    with pytest.raises(ValueError):
        pa_kernel.copy_page(pool, 2, 2)


def _gemma_cache(dev, kind, L=4, NB=17, seed=6):
    """A cache set at gemma-2b's page layout (block 16, one kv head of
    256), L cut from 18: bf16 {K, V}, or int8 {K, V, K-scale, V-scale}
    quantized by the one recipe; in the engine's order."""
    g = torch.Generator(device=dev).manual_seed(seed)
    k, v = (torch.randn((L, NB, 16, 1, 256), generator=g, device=dev)
            for _ in range(2))
    if kind == "fp":
        return [k.to(torch.bfloat16), v.to(torch.bfloat16)]
    (kq, ks), (vq, vs) = pa_ref.quantize_rows(k), pa_ref.quantize_rows(v)
    return [kq, vq, ks.contiguous(), vs.contiguous()]


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_cuda_copy_pages_bit_equal(cuda_device, kind):
    """copy_pages over a cache set at gemma-2b's page layout: in every pool
    page dst equals page src bit for bit in every layer, every other page
    is untouched, equal to the plain version's; one launch a call, host
    ids and device ids."""
    pools = _gemma_cache(cuda_device, kind)
    NB = pools[0].shape[1]
    for ids in ((3, 7), (torch.tensor([12, 2], dtype=torch.int32,
                                      device=cuda_device),)):
        before = [p.clone() for p in pools]
        src, dst = ids if len(ids) == 2 else ids[0].tolist()
        want = pa_ref.copy_pages([p.clone() for p in pools], src, dst)
        n = pa_kernel.copy_launches
        got = pa_kernel.copy_pages(pools, *ids)
        torch.cuda.synchronize()
        assert pa_kernel.copy_launches == n + 1
        assert all(g is p for g, p in zip(got, pools))
        keep = [p for p in range(NB) if p != dst]
        for p, b, w in zip(pools, before, want):
            assert torch.equal(p, w)
            assert torch.equal(p[:, dst], b[:, src])
            assert torch.equal(p[:, keep], b[:, keep])
    assert pa_kernel.copy_page_errors(cuda_device) == 0


def test_cuda_copy_pages_bad_device_ids(cuda_device):
    """Bad device ids copy nothing in any pool of an int8 cache set and set
    the error flag, once a call; host ids are checked on the host."""
    pools = _gemma_cache(cuda_device, "int8", L=2)
    before = [p.clone() for p in pools]
    NB = pools[0].shape[1]
    for bad in ([4, 4], [0, NB], [-1, 3]):
        n = pa_kernel.copy_launches
        pa_kernel.copy_pages(pools, torch.tensor(bad, dtype=torch.int32,
                                                 device=cuda_device))
        assert pa_kernel.copy_launches == n + 1
        assert pa_kernel.copy_page_errors(cuda_device) == 1
    assert all(torch.equal(p, b) for p, b in zip(pools, before))
    assert pa_kernel.copy_page_errors(cuda_device) == 0
    with pytest.raises(ValueError):
        pa_kernel.copy_pages(pools, 2, NB)
    with pytest.raises(ValueError):
        pa_kernel.copy_pages(pools + [pools[0]], 1, 2)


# glm4-9b decode (32 heads over 2 kv heads), olmoe-1b-7b's prefill chunk
# crossing pages (16 heads, 16 kv heads), grok-1-314b's GQA (48 over 8)
# with softcap 30: head_dim 128, bf16, block 16, several splits a request
D128_CASES = {
    "glm4_9b_decode": (dict(S=1, filled=[40, 47, 33, 63], ns=[1, 1, 1, 1],
                            Hkv=2, G=16, BS=16, MB=6, D=128), 0.0),
    "olmoe_prefill": (dict(S=16, filled=[8, 20, 0], ns=[16, 16, 11],
                           Hkv=16, G=1, BS=16, MB=4, D=128), 0.0),
    "grok_softcap": (dict(S=2, filled=[30, 55, 4], ns=[2, 1, 2], Hkv=8, G=6,
                          BS=16, MB=6, D=128), 30.0),
}


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("case", list(D128_CASES))
def test_cuda_walk_d128_matches_plain(cuda_device, case, quant):
    """The walk at head_dim 128, split over pages: the fused update (fp and
    int8 pools) and the read-only walk against the plain versions, live
    rows within the bf16 tolerance, every output finite, the update's
    pools (and scale pools) bit-equal, the read-only walk's untouched; a
    walk that skips the scatter reads above the tolerance.  With int8
    pools the outputs are held to the plain version in the TPU kernel's
    precision (``repro/kernels/paged_attention/kernel.py:114-139``
    dequantizes the pages into fp32 and keeps p in fp32, as this kernel
    does): the plain version on fp32 q and fresh rows.  On q's bf16 it
    rounds the dequantized pages and p to bf16, and at the grok shape it
    lands 2 bf16 ulps (0.03125, on an H100) from the kernel, further from
    the fp32 result than the kernel is."""
    shape, softcap = D128_CASES[case]
    tol = 3e-2
    c = make_case(40, **shape)
    t = _on(cuda_device, c, torch.bfloat16)
    kp, vp, kw = t["kp"], t["vp"], {}
    up = {k: t[k].float() if quant else t[k] for k in ("q", "kn", "vn")}
    if quant:
        kp, vp, ks, vs = _int8_pools(cuda_device, c, 7)
        kw = dict(k_scale=ks, v_scale=vs)
    args = dict(window=FULL, softcap=softcap, max_live_blocks=c["live"])
    assert pa_kernel.walk_plan(len(shape["filled"]), shape["S"], shape["G"],
                               shape["Hkv"], 128, 16, c["live"],
                               shape["MB"]).n_split > 1
    mask = torch.from_numpy(c["pos"] >= 0).to(cuda_device)
    res = {}
    for name, fn in (("plain", pa_ref.unified_attention_update),
                     ("kernel", pa_kernel.paged_attention_update)):
        res[name] = fn(t["q"], t["kn"], t["vn"], kp.clone(), vp.clone(),
                       t["tables"], t["pos"], **args,
                       **{k: v.clone() for k, v in kw.items()})
    want = pa_ref.unified_attention_update(
        up["q"], up["kn"], up["vn"], kp.clone(), vp.clone(), t["tables"],
        t["pos"], **args, **{k: v.clone() for k, v in kw.items()})[0]
    before = [x.clone() for x in (kp, vp, *kw.values())]
    n = pa_kernel.readonly_launches
    ro = pa_kernel.paged_attention(t["q"], kp, vp, t["tables"], t["pos"],
                                   **args, **kw)
    ro_want = pa_ref.paged_attention(up["q"], kp, vp, t["tables"],
                                     t["pos"], **args, **kw)
    torch.cuda.synchronize()
    want = want.float()
    assert (res["kernel"][0].float() - want)[mask].abs().max() <= tol
    assert (ro.float() - ro_want.float())[mask].abs().max() <= tol
    assert (ro_want.float() - want)[mask].abs().max() > tol
    assert torch.isfinite(res["kernel"][0].float()).all()
    assert torch.isfinite(ro.float()).all()
    assert pa_kernel.readonly_launches == n + 1
    for a, b in zip(res["kernel"][1:], res["plain"][1:]):
        assert torch.equal(a[1:], b[1:])
    for x, y in zip((kp, vp, *kw.values()), before):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"),
                                dict(prefix_cache=True),
                                dict(unified=False)],
                         ids=["int8", "prefix_cache", "legacy"])
def test_cuda_engine_options_token_exact(cuda_device, kw):
    """The engine's ported options on the card (reduced granite-3-2b,
    fp32, output projections x8 as in test_cuda_engine_token_exact): the
    streams equal the same engine's on the CPU (the plain versions), with
    int8 pages the int8 update launching once per layer per pass, with the
    prefix cache copy_page launching (a fully cached prompt re-served) and
    the two-dispatch tick on the fp update."""
    from repro_torch.config import get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.serving import PagedServingEngine
    cfg = reduced(get_config("granite-3-2b"))
    params = M.init_params(cfg, seed=0, device="cpu")
    for k in ("attn", "mlp"):
        params["layers"][k]["wo"] *= 8.0
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (8, 3, 10)]
    prompts.append(prompts[0].copy())
    outs, counts = [], None
    for dev in (torch.device("cpu"), cuda_device):
        eng = PagedServingEngine(cfg, _to(params, dev), max_slots=2,
                                 block_size=4, max_blocks_per_seq=8,
                                 prefill_chunk=4, device=dev, **kw)
        before = (pa_kernel.launches, pa_kernel.int8_launches,
                  pa_kernel.copy_launches)
        ids = [eng.submit(p, 5) for p in prompts[:3]]
        res = eng.run_to_completion()
        ids.append(eng.submit(prompts[3], 5))
        res.update(eng.run_to_completion())
        outs.append([res[i] for i in ids])
        counts = [a - b for a, b in zip((pa_kernel.launches,
                                         pa_kernel.int8_launches,
                                         pa_kernel.copy_launches), before)]
    assert outs[0] == outs[1]
    per_pass = cfg.n_layers * eng.dispatches
    if "kv_dtype" in kw:
        assert counts[:2] == [0, per_pass]
    else:
        assert counts[:2] == [per_pass, 0]
    if "prefix_cache" in kw:
        assert eng.metrics()["prefix_cache"]["cow_copies"] > 0
        # one launch a copy-on-write, over every pool of the cache
        assert counts[2] == eng.metrics()["prefix_cache"]["cow_copies"]


# --- the split walk and the fused int8 quantize ------------------------------

# (shape, window, softcap, max_live_blocks or None for the case's own)
SPLIT_CASES = {
    # block 4: four pages a split, 9 to 15 pages a request
    "pages_gt_splits": (dict(S=2, filled=[30, 55, 4], ns=[2, 1, 2], Hkv=1,
                             G=8, BS=4, MB=16, D=256), FULL, 0.0, None),
    # block 16: one page a split
    "one_page_a_split": (dict(S=1, filled=[40, 47, 33, 63], ns=[1, 1, 1, 1],
                              Hkv=1, G=8, BS=16, MB=6, D=256), FULL, 0.0,
                         None),
    "window_softcap": (dict(S=16, filled=[30, 0, 60, 17], ns=[16, 16, 5, 1],
                            Hkv=2, G=4, BS=16, MB=6, D=64), 12, 20.0, None),
    # request 1 has no live row: finite output, no NaN
    "fully_padded": (dict(S=3, filled=[20, 0, 9], ns=[3, 0, 2], Hkv=2, G=2,
                          BS=4, MB=8, D=16), FULL, 0.0, None),
    # request 0's rows at 32..35 land on page 2, past the walk's 2 pages
    "past_live": (dict(S=16, filled=[20, 2], ns=[16, 1], Hkv=2, G=4, BS=16,
                       MB=4, D=64), FULL, 0.0, 2),
}


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_cuda_split_walk_matches_plain(cuda_device, case, dtype, tol, quant):
    """The walk split over pages, the fused update and the read-only walk,
    against the plain versions: live-row outputs within the existing
    tolerances, every output finite, the update's pools (and scale pools)
    bit-equal to the plain scatter's, the read-only walk's untouched."""
    shape, window, softcap, live = SPLIT_CASES[case]
    c = make_case(31, **shape)
    live = c["live"] if live is None else live
    plan = pa_kernel.walk_plan(len(shape["filled"]), shape["S"], shape["G"],
                               shape["Hkv"], shape["D"], shape["BS"], live,
                               shape["MB"])
    assert plan.n_split > 1 or case in ("fully_padded", "past_live")
    t = _on(cuda_device, c, dtype)
    kp, vp, kw = t["kp"], t["vp"], {}
    if quant:
        kp, vp, ks, vs = _int8_pools(cuda_device, c, 5)
        kw = dict(k_scale=ks, v_scale=vs)
    args = dict(window=window, softcap=softcap, max_live_blocks=live)
    mask = torch.from_numpy(c["pos"] >= 0).to(cuda_device)
    res = {}
    for name, fn in (("plain", pa_ref.unified_attention_update),
                     ("kernel", pa_kernel.paged_attention_update)):
        res[name] = fn(t["q"], t["kn"], t["vn"], kp.clone(), vp.clone(),
                       t["tables"], t["pos"], **args,
                       **{k: v.clone() for k, v in kw.items()})
    before = [x.clone() for x in (kp, vp, *kw.values())]
    ro = pa_kernel.paged_attention(t["q"], kp, vp, t["tables"], t["pos"],
                                   **args, **kw)
    ro_want = pa_ref.paged_attention(t["q"], kp, vp, t["tables"], t["pos"],
                                     **args, **kw)
    torch.cuda.synchronize()
    want = res["plain"][0].float()
    assert (res["kernel"][0].float() - want)[mask].abs().max() <= tol
    assert (ro.float() - ro_want.float())[mask].abs().max() <= tol
    assert torch.isfinite(res["kernel"][0].float()).all()
    assert torch.isfinite(ro.float()).all()
    for a, b in zip(res["kernel"][1:], res["plain"][1:]):
        assert torch.equal(a[1:], b[1:])
    for x, y in zip((kp, vp, *kw.values()), before):
        assert torch.equal(x, y)


def test_cuda_split_walk_row_invariant(cuda_device):
    """A split walks a fixed run of keys, so a row's output does not depend
    on the walk's live-block bound or on the requests beside it: decode
    rows bit-equal with max_live_blocks at its least and at the table's
    width, and a request alone bit-equal to its row in the batch."""
    c = make_case(32, S=1, filled=[40, 47, 33, 63], ns=[1, 1, 1, 1], Hkv=1,
                  G=8, BS=16, MB=8, D=256)
    t = _on(cuda_device, c, torch.bfloat16)
    outs = [pa_kernel.paged_attention(t["q"], t["kp"], t["vp"], t["tables"],
                                      t["pos"], window=FULL, softcap=0.0,
                                      max_live_blocks=L)
            for L in (c["live"], 8)]
    alone = pa_kernel.paged_attention(t["q"][2:3], t["kp"], t["vp"],
                                      t["tables"][2:3], t["pos"][2:3],
                                      window=FULL, softcap=0.0,
                                      max_live_blocks=3)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(alone, outs[0][2:3])


def _quantize_rows_case(dtype, D):
    """Fresh K/V rows (B 1, S 4, Hkv 2) that test the quantize's edges:
    a row whose every value is a tie (x * inv = n + 0.5 exactly: amax 127
    gives scale 1 and inv 1), an all-zero row, a row of +-amax (q = +-127),
    the rest normal."""
    rng = np.random.default_rng(33)
    k = rng.standard_normal((1, 4, 2, D)).astype(np.float32)
    v = rng.standard_normal((1, 4, 2, D)).astype(np.float32)
    ties = rng.integers(-126, 126, D) + 0.5
    ties[0] = 127.0
    k[0, 0, 0] = ties
    k[0, 0, 1] = 0.0
    v[0, 1, 0] = np.where(rng.random(D) < 0.5, -3.25, 3.25)
    v[0, 2, 1] = 0.0
    return (torch.from_numpy(k).to(dtype), torch.from_numpy(v).to(dtype))


@pytest.mark.parametrize("dtype,D", [(torch.float32, 16),
                                     (torch.float32, 256),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 256)],
                         ids=["fp32-16", "fp32-256", "bf16-64", "bf16-256"])
def test_cuda_fused_quantize_bit_equal(cuda_device, dtype, D):
    """The int8 update quantizes the fresh rows in the kernel: the K/V
    pools and scale pools bit-equal to the plain ``write_kv`` (that is,
    ``ref.quantize_rows``) run on the card, for exact half-way ties
    (rounded to even), an all-zero row and a row at +-amax."""
    kn, vn = _quantize_rows_case(dtype, D)
    q_tie, s_tie = pa_ref.quantize_rows(kn[0, 0, 0])
    # scale 1: every value but the amax is a tie, rounded to an even q
    assert s_tie.item() == 1.0 and (q_tie[1:] % 2 == 0).all()
    c = make_case(34, S=4, filled=[5], ns=[4], Hkv=2, G=2, BS=4, MB=4, D=D)
    t = _on(cuda_device, c, dtype)
    t["kn"], t["vn"] = kn.to(cuda_device), vn.to(cuda_device)
    kp, vp, ks, vs = _int8_pools(cuda_device, c, 6)
    got = pa_kernel.paged_attention_update(
        t["q"], t["kn"], t["vn"], kp.clone(), vp.clone(), t["tables"],
        t["pos"], window=FULL, softcap=0.0, max_live_blocks=c["live"],
        k_scale=ks.clone(), v_scale=vs.clone())
    want = pa_ref.write_kv(kp.clone(), vp.clone(), t["kn"], t["vn"],
                           t["pos"], t["tables"], ks.clone(), vs.clone())
    torch.cuda.synchronize()
    for a, b in zip(got[1:], want):
        assert torch.equal(a, b)
    slot = int(c["tables"][0, 5 // 4]) * 4 + 5 % 4
    assert torch.equal(got[1].view(-1, 2, D)[slot, 0].cpu(), q_tie)
    assert (got[1].view(-1, 2, D)[slot, 1] == 0).all()
    assert got[3].view(-1, 2)[slot, 1].item() == 0.0


@pytest.mark.parametrize("n_split", [1, 3], ids=["one_split", "splits"])
def test_cuda_int8_update_one_kernel_on_stream(cuda_device, n_split):
    """An int8 update puts exactly one kernel on the stream: the quantize,
    the scatter, the split walk and the combine are all in it (the
    workspace and the output are allocated, not written, by PyTorch)."""
    filled = 3 if n_split == 1 else 40
    c = make_case(35, S=1, filled=[filled, filled], ns=[1, 1], Hkv=1, G=8,
                  BS=16, MB=4, D=256)
    t = _on(cuda_device, c, torch.bfloat16)
    kp, vp, ks, vs = _int8_pools(cuda_device, c, 7)
    assert pa_kernel.walk_plan(2, 1, 8, 1, 256, 16, c["live"],
                               4).n_split == n_split

    def call():
        return pa_kernel.paged_attention_update(
            t["q"], t["kn"], t["vn"], kp, vp, t["tables"], t["pos"],
            window=FULL, softcap=0.0, max_live_blocks=c["live"], k_scale=ks,
            v_scale=vs)

    call()                              # builds; grows the counters
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(on_card) == 1 and "paged_kernel" in on_card[0], on_card


# --- the CATopt fitness kernel ----------------------------------------------

def fitness_case(dev, seed, E, m, P, att=5.0, limit=20.0):
    """test_recovery_vs_ref's inputs (|normal| losses and targets, uniform
    weights), drawn with numpy and moved to ``dev``."""
    rng = np.random.default_rng(seed)
    il = np.abs(rng.standard_normal((E, m))).astype(np.float32)
    w = rng.uniform(size=(P, m)).astype(np.float32)
    target = np.abs(rng.standard_normal(E)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(il), t(w), t(target), att, limit


FIT_RTOL = 1e-5


@pytest.mark.parametrize("E,m,P,att,limit", [
    (256, 128, 16, 5.0, 20.0), (500, 300, 37, 5.0, 20.0),
    (128, 512, 64, 5.0, 20.0), (1024, 256, 8, 5.0, 20.0),
    (500, 300, 37, -4.0, 124.0), (777, 130, 65, 45.0, 20.0)])
def test_cuda_fitness_matches_plain(cuda_device, E, m, P, att, limit):
    """sq within FIT_RTOL relative of the plain version (fp32 sums in
    another order), at test_recovery_vs_ref's shapes, an att < 0 case and
    one ragged in every tile dimension whose losses straddle both clips.
    Dropping the clip, or the last tile of events, lands outside it."""
    from repro_torch.kernels.recovery import kernel, ref
    il, w, target, att, limit = fitness_case(cuda_device, E, E + m + P, m,
                                             P, att, limit)
    got = kernel.fitness_sq(il, w, target, att, limit)
    want = ref.fitness_sq(il, w, target, att, limit)
    torch.cuda.synchronize()

    def rel(x):
        return ((x - want).abs() / want.abs()).max().item()

    assert rel(got) <= FIT_RTOL
    no_clip = torch.square(w @ il.T - att - target).sum(-1)
    cut = (E - 1) // kernel.BLOCK_EVENTS * kernel.BLOCK_EVENTS
    last_tile_dropped = ref.fitness_sq(il[:cut], w, target[:cut], att, limit)
    assert rel(no_clip) > FIT_RTOL and rel(last_tile_dropped) > FIT_RTOL


def test_cuda_fitness_deterministic_and_row_local(cuda_device):
    """Bit-equal across calls, and a row's sq does not depend on the
    population around it (the GA compares clones' fitness)."""
    from repro_torch.kernels.recovery import kernel
    il, w, target, att, limit = fitness_case(cuda_device, 5, 700, 200, 90)
    a = kernel.fitness_sq(il, w, target, att, limit)
    b = kernel.fitness_sq(il, w, target, att, limit)
    c = kernel.fitness_sq(il, w[70:75].contiguous(), target, att, limit)
    assert torch.equal(a, b) and torch.equal(a[70:75], c)


def test_cuda_fitness_gradient_matches_plain(cuda_device):
    """The autograd Function's backward (plain products) against autograd
    through the plain version, on the card.  Losses straddle both clips;
    no row reaches the budget, so the gradient is the fitness's alone."""
    from repro_torch.kernels.recovery import ops, ref
    il, w, target, att, limit = fitness_case(cuda_device, 6, 1000, 300, 4)
    w = w * (2 * (att + limit / 2) / (0.8 * 300))
    il = il * torch.linspace(0, 3, 1000, device=cuda_device)[:, None]
    budget = 2 * float(w.sum(-1).max())
    grads = []
    for fn in (ops.basis_risk, ref.basis_risk):
        wt = w.clone().requires_grad_(True)
        fn(il, target, wt, att, limit, budget).sum().backward()
        grads.append(wt.grad)
    torch.cuda.synchronize()
    err = (grads[0] - grads[1]).abs().max() / grads[1].abs().max()
    assert err.item() <= 1e-4


@pytest.mark.parametrize("P", range(1, 9))
def test_cuda_fitness_narrow_bit_equal_to_wide(cuda_device, P):
    """For P <= P_NARROW the narrow kernel runs, and each row's sq equals
    the wide kernel's bit for bit (the same rows inside a population of
    16, which takes the wide kernel): ragged E and m (m 130 and 257 take
    4-byte copies), att < 0, and losses spread over 0 to 3x the mean, so
    they straddle both clips.  Within FIT_RTOL of the plain version."""
    from repro_torch.kernels.recovery import kernel, ref
    for E, m, att, limit in ((777, 130, 45.0, 20.0), (500, 300, -4.0, 124.0),
                             (1000, 257, 40.0, 30.0)):
        il, w, target, att, limit = fitness_case(cuda_device, E + P, E, m,
                                                 16, att, limit)
        il = il * torch.linspace(0, 3, E, device=cuda_device)[:, None]
        w = w * (2 * (att + limit / 2) / (0.8 * m))
        assert kernel.fitness_plan(E, m, P).route == "narrow"
        assert kernel.fitness_plan(E, m, 16).route == "wide"
        wide = kernel.fitness_sq(il, w, target, att, limit)
        narrow = kernel.fitness_sq(il, w[:P].contiguous(), target, att,
                                   limit)
        want = ref.fitness_sq(il, w[:P], target, att, limit)
        torch.cuda.synchronize()
        assert torch.equal(narrow, wide[:P])
        assert ((narrow - want).abs() / want.abs()).max().item() <= FIT_RTOL


def test_cuda_fitness_counts_launches(cuda_device):
    from repro_torch.kernels.recovery import kernel, ops
    il, w, target, att, limit = fitness_case(cuda_device, 7, 64, 16, 3)
    before = kernel.launches
    ops.basis_risk(il, target, w, att, limit, 30.0)
    assert kernel.launches == before + 1


# ---------------------------------------------------------------------------
# Flash attention: forward (with and without lse), dq and dk/dv kernels
# ---------------------------------------------------------------------------

# the worst row's ||kernel - plain|| / ||plain|| (``_row_err``).  fp32:
# summation order.  bf16:
# outputs rounded to bf16 (ulp 2^-8 relative); the forward's p is rounded
# at another running max, the plain backward rounds per-head dk/dv to
# bf16 before the group sum, the kernel once after it.
FLASH_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (B, S, H, Hkv, D, causal, window, softcap): granite-3-2b's heads, gemma
# MQA at D 256, D 128 with a ragged S, the launcher's reduced D 40, and
# the masks; then the bf16 tiling's edges: one row past a 64-row tile
# under window and softcap, 127 rows of D 20 (8-byte copies), granite-3-2b
# at (b), and an odd D 33 (plain loads, no cp.async)
FLASH_CASES = [(2, 160, 32, 8, 64, True, 0, 0.0),
               (1, 96, 8, 1, 256, True, 32, 30.0),
               (1, 200, 4, 2, 128, False, 0, 0.0),
               (2, 130, 4, 2, 40, True, 0, 30.0),
               (1, 65, 32, 8, 64, True, 32, 30.0),
               (2, 127, 4, 2, 20, False, 0, 0.0),
               (1, 4096, 32, 8, 64, True, 0, 0.0),
               (1, 96, 4, 1, 33, True, 0, 0.0)]


def flash_case(dev, dtype, B, S, H, Hkv, D, seed=0):
    g = torch.Generator().manual_seed(seed)
    mk = lambda rows: torch.randn(rows, S, D, generator=g).to(  # noqa: E731
        dev, dtype)
    return mk(B * H), mk(B * Hkv), mk(B * Hkv), mk(B * H)


def _row_err(got, want):
    """The worst row's ||got - want|| / ||want|| over the last axis (a
    query's o or dq, a key's dk or dv), a row below a tenth of the median
    row's norm held to that tenth (dq of a query that sees one key is
    zero up to rounding)."""
    err = torch.linalg.vector_norm(got.float() - want.float(), dim=-1)
    norm = torch.linalg.vector_norm(want.float(), dim=-1)
    return (err / torch.clamp(norm, min=0.1 * norm.median())).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window,softcap", FLASH_CASES)
def test_cuda_flash_forward_matches_plain(cuda_device, B, S, H, Hkv, D,
                                          causal, window, softcap, dtype):
    """o (both forwards) within FLASH_RTOL of the plain version, lse
    within 1e-5 of its largest value;
    the causal mask dropped lands outside it."""
    from repro_torch.kernels.flash_attention import kernel, ref
    q, k, v, _ = flash_case(cuda_device, dtype, B, S, H, Hkv, D)
    opts = dict(n_q_heads=H, causal=causal, window=window, softcap=softcap)
    o, lse = kernel.flash_fwd(q, k, v, with_lse=True, **opts)
    o2 = kernel.flash_fwd(q, k, v, **opts)
    po, plse = ref.flash_fwd(q, k, v, with_lse=True, **opts)
    torch.cuda.synchronize()
    tol = FLASH_RTOL[dtype]
    assert torch.equal(o, o2) and o.dtype == dtype
    assert _row_err(o, po) <= tol
    assert (lse - plse).abs().max() <= 1e-5 * plse.abs().max()
    wrong = ref.flash_fwd(q, k, v, **dict(opts, causal=not causal))
    assert _row_err(wrong, po) > tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window,softcap", FLASH_CASES)
def test_cuda_flash_backward_matches_plain(cuda_device, B, S, H, Hkv, D,
                                           causal, window, softcap, dtype):
    """dq, and dk, dv per KV head, within FLASH_RTOL of the plain backward
    followed by its group sum, from the same lse and dsum; bit-equal
    across calls (no atomics).  dk not group-summed lands outside it."""
    from repro_torch.kernels.flash_attention import kernel, ref
    q, k, v, do = flash_case(cuda_device, dtype, B, S, H, Hkv, D, seed=1)
    opts = dict(n_q_heads=H, causal=causal, window=window, softcap=softcap)
    o, lse = ref.flash_fwd(q, k, v, with_lse=True, **opts)
    dsum = (do.float() * o.float()).sum(-1)
    got = kernel.flash_bwd(q, k, v, do, lse, dsum, **opts)
    again = kernel.flash_bwd(q, k, v, do, lse, dsum, **opts)
    dq, dk_h, dv_h = ref.flash_bwd(q, k, v, do, lse, dsum, **opts)
    want = (dq, ref.group_sum(dk_h, H, k.shape[0]),
            ref.group_sum(dv_h, H, k.shape[0]))
    torch.cuda.synchronize()
    tol = FLASH_RTOL[dtype]
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
        assert a.shape == b.shape and a.dtype == dtype, name
        assert _row_err(a, b) <= tol, name
        assert torch.equal(a, c), name
    if H > Hkv:
        one_head = dk_h.reshape(B, Hkv, H // Hkv, S, D)[:, :, 0]
        assert _row_err(one_head.reshape(B * Hkv, S, D), want[1]) > tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", [
    (1, 100, 170, 4, 2, 64, True, 0), (1, 170, 100, 4, 2, 64, True, 0),
    (2, 150, 90, 4, 1, 40, False, 0), (1, 4096, 4096, 32, 8, 64, True, 32)])
def test_cuda_flash_unequal_lengths_and_long_window(cuda_device, B, Sq, Sk,
                                                    H, Hkv, D, causal,
                                                    window, dtype):
    """Sq != Sk both ways (every query sees a key) and granite-3-2b's
    heads at S 4096 under a 32-token window: o, lse, dq, dk and dv within
    FLASH_RTOL of the plain versions."""
    from repro_torch.kernels.flash_attention import kernel, ref
    g = torch.Generator().manual_seed(3)
    mk = lambda rows, S: torch.randn(rows, S, D, generator=g).to(  # noqa: E731
        cuda_device, dtype)
    q, k, v, do = mk(B * H, Sq), mk(B * Hkv, Sk), mk(B * Hkv, Sk), \
        mk(B * H, Sq)
    opts = dict(n_q_heads=H, causal=causal, window=window)
    o, lse = kernel.flash_fwd(q, k, v, with_lse=True, **opts)
    po, plse = ref.flash_fwd(q, k, v, with_lse=True, **opts)
    dsum = (do.float() * po.float()).sum(-1)
    got = kernel.flash_bwd(q, k, v, do, plse, dsum, **opts)
    dq, dk_h, dv_h = ref.flash_bwd(q, k, v, do, plse, dsum, **opts)
    want = (dq, ref.group_sum(dk_h, H, k.shape[0]),
            ref.group_sum(dv_h, H, k.shape[0]))
    torch.cuda.synchronize()
    tol = FLASH_RTOL[dtype]
    assert _row_err(o, po) <= tol
    assert (lse - plse).abs().max() <= 1e-5 * plse.abs().max()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _row_err(a, b) <= tol, name


def test_cuda_flash_sass_tensor_cores(cuda_device):
    """The bf16 kernels (forward with and without lse, dq, dk/dv, every
    head dim) hold tensor-core (HMMA) and asynchronous-copy (LDGSTS)
    instructions; the fp32 ones, scalar FMA, hold no HMMA."""
    from repro_torch.kernels import _build
    if _build._tool("cuobjdump") is None:
        pytest.skip("needs cuobjdump (CUDA toolkit) to read the SASS")
    counts = _build.sass_counts("flash_attention")
    mma = {f: c for f, c in counts.items() if "_mma" in f}
    scalar = {f: c for f, c in counts.items()
              if "flash_" in f and "_mma" not in f}
    assert len(mma) == 20 and len(scalar) == 20, sorted(counts)
    for f, c in mma.items():
        assert c["HMMA"] > 0 and c["LDGSTS"] > 0, (f, c)
    for f, c in scalar.items():
        assert c["HMMA"] == 0, (f, c)


def test_cuda_flash_trainable_and_counts(cuda_device):
    """attention_trainable on the card: one forward-with-lse launch, one
    dq and one dk/dv launch per backward, none without a gradient; grads
    match autograd through the plain forward."""
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    B, S, H, Hkv, D = 2, 100, 8, 2, 64
    g = torch.Generator().manual_seed(2)
    x = [torch.randn(B, S, h, D, generator=g).to(cuda_device)
         for h in (H, Hkv, Hkv)]
    before = (kernel.fwd_launches, kernel.fwd_lse_launches,
              kernel.dq_launches, kernel.dkv_launches)
    with torch.no_grad():
        ops.attention_trainable(*x, window=24)
    ts = [t.clone().requires_grad_(True) for t in x]
    torch.sin(ops.attention_trainable(*ts, window=24)).sum().backward()
    after = (kernel.fwd_launches, kernel.fwd_lse_launches,
             kernel.dq_launches, kernel.dkv_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1, 1)
    rs = [t.clone().requires_grad_(True) for t in x]
    torch.sin(ref.attention(*rs, window=24)).sum().backward()
    torch.cuda.synchronize()
    for a, b in zip(ts, rs):
        assert _row_err(a.grad, b.grad) <= 1e-4


# ---------------------------------------------------------------------------
# The RWKV-6 recurrence (wkv6)
# ---------------------------------------------------------------------------

# the worst row's ||kernel - plain|| / ||plain|| (``_row_err``; a row is one
# token's output of one head).  fp32: sums over D in another order.  bf16:
# the kernel rounds its output to bf16, up to 2^-8 of each value, against
# the plain version's fp32 output from the same inputs.
WKV_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# (B, S, H, D): the shapes of the JAX package's test_wkv6_vs_ref
WKV_CASES = [(2, 64, 4, 16), (1, 96, 2, 32), (2, 128, 3, 64), (1, 64, 1, 128)]


def wkv_case(dev, dtype, B, S, H, D, seed=0, w_dtype=None):
    """r, k, v normal, w = sigmoid(normal), u = normal x 0.1, as the JAX
    test draws them; r, k, v in ``dtype``, w in ``w_dtype`` (the same by
    default), u fp32."""
    g = torch.Generator().manual_seed(seed)
    rkv = [torch.randn(B, S, H, D, generator=g).to(dev, dtype)
           for _ in range(3)]
    w = torch.sigmoid(torch.randn(B, S, H, D, generator=g)).to(
        dev, w_dtype or dtype)
    u = (torch.randn(H, D, generator=g) * 0.1).to(dev)
    return (*rkv, w, u)


@pytest.mark.parametrize("dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)], ids=["fp32", "bf16", "bf16_w_fp32"])
@pytest.mark.parametrize("B,S,H,D", WKV_CASES)
def test_cuda_wkv6_matches_plain(cuda_device, B, S, H, D, dtype, w_dtype):
    """Each token's output within WKV_RTOL of the plain version, in r's
    dtype, bit-equal across calls; the bonus u dropped lands outside."""
    from repro_torch.kernels.wkv6 import kernel, ref
    r, k, v, w, u = wkv_case(cuda_device, dtype, B, S, H, D,
                             w_dtype=w_dtype)
    got = kernel.wkv6(r, k, v, w, u)
    again = kernel.wkv6(r, k, v, w, u)
    want = ref.wkv(r, k, v, w, u)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, S, H, D)
    assert torch.equal(got, again)
    assert _row_err(got, want) <= WKV_RTOL[dtype]
    assert _row_err(ref.wkv(r, k, v, w, torch.zeros_like(u)), want) > \
        WKV_RTOL[dtype]


def test_cuda_wkv6_reads_strided_inputs(cuda_device):
    """r, k, v as views of one (B, S, 3, H, D) projection and w as every
    other head of a wider tensor: read by stride, no copies needed, the
    same result as from contiguous copies."""
    from repro_torch.kernels.wkv6 import kernel
    B, S, H, D = 2, 70, 3, 64
    g = torch.Generator().manual_seed(3)
    rkv = torch.randn(B, S, 3, H, D, generator=g).to(cuda_device)
    w = torch.sigmoid(torch.randn(B, S, 2 * H, D, generator=g)).to(
        cuda_device)[:, :, ::2]
    u = torch.randn(H, D, generator=g).to(cuda_device) * 0.1
    r, k, v = rkv.unbind(2)
    assert not r.is_contiguous() and not w.is_contiguous()
    got = kernel.wkv6(r, k, v, w, u)
    want = kernel.wkv6(*(t.contiguous() for t in (r, k, v, w)), u)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_cuda_wkv6_op_counts_and_has_no_gradient(cuda_device):
    """The op launches the kernel once a call; with a gradient being
    recorded it raises rather than run the plain version."""
    from repro_torch.kernels.wkv6 import kernel, ops
    r, k, v, w, u = wkv_case(cuda_device, torch.float32, 1, 33, 2, 32)
    before = kernel.launches
    ops.wkv(r, k, v, w, u)
    assert kernel.launches == before + 1
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.wkv(r.requires_grad_(True), k, v, w, u)
    with torch.no_grad():
        ops.wkv(r, k, v, w, u)
    assert kernel.launches == before + 2


def test_cuda_rwkv_forward_on_the_kernel(cuda_device):
    """Reduced rwkv6-1.6b (fp32) on the card: ``use_pallas_wkv`` runs one
    wkv launch per layer and matches the exact scan; generate's greedy
    stream (the scan through the decode state) is the same with either."""
    import dataclasses
    from repro_torch.config import get_config, reduced
    from repro_torch.kernels.wkv6 import kernel
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    cfg = reduced(get_config("rwkv6-1.6b"))
    cfg_k = dataclasses.replace(cfg, use_pallas_wkv=True)
    params = M.init_params(cfg, seed=0, device=cuda_device)
    g = torch.Generator().manual_seed(4)
    u = params["layers"]["rwkv"]["tm"]["u"]
    u.copy_(torch.randn(u.shape, generator=g) * 0.1)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=g).to(cuda_device)
    before = kernel.launches
    with torch.no_grad():
        hk = M.forward(cfg_k, params, {"tokens": toks})
        hs = M.forward(cfg, params, {"tokens": toks})
    assert kernel.launches == before + cfg.n_layers
    torch.cuda.synchronize()
    assert _row_err(hk, hs) <= 1e-4
    assert torch.equal(generate(cfg_k, params, toks[:, :9], 6),
                       generate(cfg, params, toks[:, :9], 6))


# --- the redesigned wide fitness tile and the split wkv walk ----------------

def _fitness_spread(dev, seed, E, m, P, att, limit):
    """fitness_case's inputs with losses spread over 0 to 3x the mean, so
    rows straddle both clips."""
    il, w, target, att, limit = fitness_case(dev, seed, E, m, P, att, limit)
    il = il * torch.linspace(0, 3, E, device=dev)[:, None]
    w = w * (2 * (att + limit / 2) / (0.8 * m))
    return il, w, target, att, limit


@pytest.mark.parametrize("P", range(1, 9))
def test_cuda_fitness_wide_p200_rows_bit_equal_to_narrow(cuda_device, P):
    """At the GA's P 200 (the wide kernel, two tiles of individuals), rows
    0 .. P-1 equal the narrow kernel's call on those P rows bit for bit:
    ragged E and m (16- and 4-byte copies), att < 0 among them."""
    from repro_torch.kernels.recovery import kernel
    for E, m, att, limit in ((777, 130, 45.0, 20.0), (1000, 256, -4.0, 124.0),
                             (8192, 2048, 5.0, 20.0)):
        il, w, target, att, limit = _fitness_spread(cuda_device, E + P, E, m,
                                                    200, att, limit)
        assert kernel.fitness_plan(E, m, 200).route == "wide"
        wide = kernel.fitness_sq(il, w, target, att, limit)
        narrow = kernel.fitness_sq(il, w[:P].contiguous(), target, att, limit)
        torch.cuda.synchronize()
        assert torch.equal(narrow, wide[:P])


@pytest.mark.parametrize("P", [9, 103, 104, 105, 111, 112, 113, 199, 200,
                               201])
def test_cuda_fitness_wide_rows_local_across_tiles(cuda_device, P):
    """Each row's sq depends on that row alone, wherever it sits in its
    tile of BLOCK_INDIVIDUALS: the population shifted by one row, reversed,
    and each tile's first and last row alone give the same bits.  Ragged
    E and m, att < 0; within FIT_RTOL of the plain version."""
    from repro_torch.kernels.recovery import kernel, ref
    E, m = 1001, 258
    il, w, target, att, limit = _fitness_spread(cuda_device, P, E, m, P,
                                                -3.0, 40.0)
    got = kernel.fitness_sq(il, w, target, att, limit)
    want = ref.fitness_sq(il, w, target, att, limit)
    shifted = kernel.fitness_sq(il, torch.cat([w[-1:], w]).contiguous(),
                                target, att, limit)
    flipped = kernel.fitness_sq(il, w.flip(0).contiguous(), target, att,
                                limit)
    T = kernel.BLOCK_INDIVIDUALS
    edges = sorted({p for t in range(0, P, T) for p in (t, min(t + T, P) - 1)})
    alone = [kernel.fitness_sq(il, w[p:p + 1].contiguous(), target, att,
                               limit) for p in edges]
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() / want.abs()).max().item() <= FIT_RTOL
    assert torch.equal(shifted[1:], got) and torch.equal(flipped.flip(0), got)
    for p, a in zip(edges, alone):
        assert torch.equal(a, got[p:p + 1]), p


# (B, S, H, D): the split's edges: one head (4 blocks of 16 columns at D
# 64), rwkv6-1.6b's heads at a length one past a 64-token chunk, D 128 (16
# blocks of 8 columns, 32-token chunks), D 16 (one block of 32 lanes), and
# D 32 at a ragged length
WKV_SPLIT_CASES = {"B1_H1_D64": (1, 300, 1, 64),
                   "B1_H32_D64_S4097": (1, 4097, 32, 64),
                   "B2_H3_D128": (2, 161, 3, 128),
                   "B3_H2_D16": (3, 77, 2, 16),
                   "B2_H2_D32": (2, 129, 2, 32)}


def _decay(g, shape, near, dev, dtype):
    """w near 0 (the model's exp(-exp(x)) at large x) or near 1."""
    x = torch.rand(shape, generator=g)
    w = 1e-6 + 1e-3 * x if near == "near0" else 0.999 + 0.00099 * x
    return w.to(dev, dtype)


@pytest.mark.parametrize("near", ["near0", "near1"])
@pytest.mark.parametrize("dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)], ids=["fp32", "bf16_w_fp32", "bf16"])
@pytest.mark.parametrize("case", list(WKV_SPLIT_CASES))
def test_cuda_wkv6_split_matches_plain(cuda_device, case, dtype, w_dtype,
                                       near):
    """Shapes that cross the split of a head's state over blocks and lanes,
    with w near 0 and near 1: each token's output within WKV_RTOL of the
    plain version, bit-equal across calls; the plan's blocks cover every
    column."""
    from repro_torch.kernels.wkv6 import kernel, ref
    B, S, H, D = WKV_SPLIT_CASES[case]
    g = torch.Generator().manual_seed(B * S + H * D)
    r, k, v = (torch.randn(B, S, H, D, generator=g).to(cuda_device, dtype)
               for _ in range(3))
    w = _decay(g, (B, S, H, D), near, cuda_device, w_dtype)
    u = (torch.randn(H, D, generator=g) * 0.1).to(cuda_device)
    plan = kernel.wkv_plan(B, H, D)
    assert plan.blocks * plan.columns == B * H * D
    got = kernel.wkv6(r, k, v, w, u)
    again = kernel.wkv6(r, k, v, w, u)
    want = ref.wkv(r, k, v, w, u)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, S, H, D)
    assert torch.equal(got, again)
    assert _row_err(got, want) <= WKV_RTOL[dtype]


def test_cuda_wkv6_column_blocks_use_their_head(cuda_device):
    """Heads with different bonus u and decay: a column block that took
    another head's u, or the dot after the update, would leave the plain
    version by more than WKV_RTOL; the kernel does not."""
    from repro_torch.kernels.wkv6 import kernel, ref
    B, S, H, D = 1, 200, 4, 64
    g = torch.Generator().manual_seed(11)
    r, k, v = (torch.randn(B, S, H, D, generator=g).to(cuda_device)
               for _ in range(3))
    w = torch.sigmoid(torch.randn(B, S, H, D, generator=g) + 2.0).to(
        cuda_device)
    u = torch.randn(H, D, generator=g).to(cuda_device)
    got = kernel.wkv6(r, k, v, w, u)
    want = ref.wkv(r, k, v, w, u)
    other_u = ref.wkv(r, k, v, w, u.roll(1, 0))
    after = ref.wkv(r * w, k, v, w, torch.zeros_like(u)) + (
        (r * k).sum(-1, keepdim=True)
        + (r * u * k).sum(-1, keepdim=True)) * v
    torch.cuda.synchronize()
    assert _row_err(got, want) <= WKV_RTOL[torch.float32]
    assert _row_err(other_u, want) > WKV_RTOL[torch.float32]
    assert _row_err(after, want) > WKV_RTOL[torch.float32]


def test_cuda_wkv6_copies_misaligned_rows(cuda_device):
    """A view whose rows do not start on 16-byte boundaries (one element
    into a flat buffer) is copied before the kernel's 16-byte copies read
    it: the same result as from an aligned copy of it."""
    from repro_torch.kernels.wkv6 import kernel
    B, S, H, D = 1, 90, 2, 64
    g = torch.Generator().manual_seed(13)
    flat = torch.randn(B * S * H * D + 1, generator=g).to(
        cuda_device, torch.bfloat16)
    r = flat[1:].view(B, S, H, D)
    k, v = (torch.randn(B, S, H, D, generator=g).to(cuda_device,
                                                     torch.bfloat16)
            for _ in range(2))
    w = torch.sigmoid(torch.randn(B, S, H, D, generator=g)).to(cuda_device)
    u = (torch.randn(H, D, generator=g) * 0.1).to(cuda_device)
    assert not kernel._rows_aligned(r)
    got = kernel.wkv6(r, k, v, w, u)
    want = kernel.wkv6(r.clone(), k, v, w, u)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# --- verify chains, swap and the host tier (speculative decoding) ------------

@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype,D,G,tol", [
    (torch.float32, 16, 2, 1e-4), (torch.bfloat16, 256, 8, 3e-2)],
    ids=["fp32_D16", "bf16_D256"])
@pytest.mark.parametrize("S", [2, 4, 5])
def test_cuda_verify_chain_update_matches_plain(cuda_device, S, dtype, D, G,
                                                tol, quant):
    """The fused update at the verify-chain widths of speculative decoding
    (``S`` = 2, 4, 5 rows a request: the last token and its draft), chains
    of every length up to ``S`` at ragged depths, one crossing a page and
    one idle row, over fp and int8 pools: live rows within ``tol`` of the
    plain version, the pools (and scale pools) bit-equal.  Two
    known-wrong readings land outside ``tol``: the scatter skipped, and
    every chain row seeing the whole chain (no causal mask inside it)."""
    ns = [S, max(1, S - 1), 1, 0]
    c = make_case(30 + S, S=S, filled=[13, 6, 40, 0], ns=ns, Hkv=1, G=G,
                  BS=4, MB=12, D=D)
    t = _on(cuda_device, c, dtype)
    kw = {}
    kp, vp = t["kp"], t["vp"]
    if quant:
        kp, vp, ks, vs = _int8_pools(cuda_device, c, 40 + S)
        kw = dict(k_scale=ks, v_scale=vs)
    res = {}
    for name, fn in (("plain", pa_ref.unified_attention_update),
                     ("kernel", pa_kernel.paged_attention_update)):
        res[name] = fn(t["q"], t["kn"], t["vn"], kp.clone(), vp.clone(),
                       t["tables"], t["pos"], window=FULL, softcap=0.0,
                       max_live_blocks=c["live"],
                       **{k: v.clone() for k, v in kw.items()})
    torch.cuda.synchronize()
    live = torch.from_numpy(c["pos"] >= 0).to(cuda_device)
    want = res["plain"][0].float()
    assert (res["kernel"][0].float() - want)[live].abs().max().item() <= tol
    assert torch.isfinite(res["kernel"][0].float()).all()
    for i in range(1, len(res["plain"])):
        assert torch.equal(res["kernel"][i][1:], res["plain"][i][1:])
    scales = dict(zip(("k_scale", "v_scale"), res["plain"][3:]))
    last = t["pos"].max(dim=1, keepdim=True).values.expand_as(t["pos"])
    unmasked = torch.where(t["pos"] >= 0, last, t["pos"])
    for wrong in (
            pa_ref.paged_attention(t["q"], kp, vp, t["tables"], t["pos"],
                                   window=FULL, softcap=0.0,
                                   max_live_blocks=c["live"], **kw),
            pa_ref.paged_attention(t["q"], *res["plain"][1:3], t["tables"],
                                   unmasked, window=FULL, softcap=0.0,
                                   max_live_blocks=c["live"], **scales)):
        assert (wrong.float() - want)[live].abs().max().item() > tol


def _engine_on(dev, kv_dtype=None, **kw):
    from repro_torch.config import get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.serving import PagedServingEngine
    cfg = reduced(get_config("granite-3-2b"))
    params = _to(M.init_params(cfg, seed=0, device="cpu"), dev)
    return PagedServingEngine(cfg, params, max_slots=2, block_size=4,
                              max_blocks_per_seq=8, num_blocks=20,
                              kv_dtype=kv_dtype, device=dev, **kw)


def _fill_random(cache, seed):
    """Random bytes in every pool of an engine's cache, drawn on the CPU."""
    for name, pool in cache.items():
        g = torch.Generator().manual_seed(seed + len(name))
        if pool.dtype == torch.int8:
            x = torch.randint(-127, 128, pool.shape, generator=g,
                              dtype=torch.int8)
        else:
            x = torch.randn(pool.shape, generator=g).to(pool.dtype)
        pool.copy_(x.to(pool.device))


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
def test_cuda_swap_round_trip_bit_equal(cuda_device, kv_dtype):
    """A swap payload holds every pool of the cache on the host (int8: the
    K/V pools and both scale pools), and copying it back into other pages
    of the card's pools is bit-equal to the pages it came from; no other
    page moves."""
    eng = _engine_on(cuda_device, kv_dtype, preempt="swap")
    _fill_random(eng.cache, 60)
    src, dst = [3, 7, 5, 19], [2, 11, 9, 1]
    before = {n: p.clone() for n, p in eng.cache.items()}
    payload = eng._pages_to_host(src)
    assert set(payload) == set(eng.cache) == (
        {"k", "v", "k_scale", "v_scale"} if kv_dtype else {"k", "v"})
    assert all(p.device.type == "cpu" for p in payload.values())
    eng._pages_from_host(dst, payload)
    torch.cuda.synchronize()
    keep = [b for b in range(eng.num_blocks) if b not in dst]
    for name, pool in eng.cache.items():
        assert torch.equal(payload[name], before[name][:, src].cpu())
        assert torch.equal(pool[:, dst], before[name][:, src]), name
        assert torch.equal(pool[:, keep], before[name][:, keep]), name


def test_cuda_host_restore_bit_equal(cuda_device):
    """The host tier on the card: evicting a cached page spills it, and
    after the device page is reused and clobbered a prefix match restores
    it into a fresh page bit-equal to the page that spilled, in every pool
    of int8 pages."""
    from repro_torch.serving.blocks import page_digest
    eng = _engine_on(cuda_device, "int8", prefix_cache=True,
                     host_cache_pages=4)
    prompt = np.arange(3, 12, dtype=np.int32)
    eng.submit(prompt, 2)
    eng.run_to_completion()
    digest = page_digest(b"", prompt[:4])
    blk = eng.alloc.lookup(digest)
    page = {n: p[:, blk].clone() for n, p in eng.cache.items()}
    taken = []
    while eng.alloc.lookup(digest) is not None:
        taken.append(eng.alloc.allocate())
    for pool in eng.cache.values():
        pool[:, taken] = 0
    eng.alloc.decref(taken)
    new = eng._restore_host_page(digest)
    torch.cuda.synchronize()
    assert new is not None and eng.alloc.lookup(digest) == new
    for name, pool in eng.cache.items():
        assert torch.equal(pool[:, new], page[name]), name


@pytest.mark.parametrize("kw", [
    dict(speculate=True), dict(speculate=True, unified=False),
    dict(speculate=True, kv_dtype="int8", prefix_cache=True),
    dict(preempt="swap"), dict(preempt="swap", kv_dtype="int8",
                               speculate=True),
    dict(prefix_cache=True, host_cache_pages=6)],
    ids=["speculate", "speculate_legacy", "speculate_int8_cache", "swap",
         "swap_int8_speculate", "host_cache"])
def test_cuda_engine_spec_swap_token_exact(cuda_device, kw):
    """Speculation, swap preemption and the host tier on the card (reduced
    granite-3-2b, fp32, output projections x8): the streams, drafted and
    accepted totals and swap counters equal the same engine's on the CPU,
    in a pool small enough to preempt and to evict cached pages, the fused
    update launching once per layer per pass."""
    from repro_torch.config import get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.serving import PagedServingEngine
    cfg = reduced(get_config("granite-3-2b"))
    params = M.init_params(cfg, seed=0, device="cpu")
    for k in ("attn", "mlp"):
        params["layers"][k]["wo"] *= 8.0
    rng = np.random.default_rng(5)
    pat = rng.integers(0, cfg.vocab, 3).astype(np.int32)
    prompts = [np.tile(pat, 3), rng.integers(0, cfg.vocab, 9).astype(
        np.int32), rng.integers(0, cfg.vocab, 11).astype(np.int32)]
    waves = [prompts, [p.copy() for p in prompts[1:]]]
    outs, reports = [], []
    for dev in (torch.device("cpu"), cuda_device):
        eng = PagedServingEngine(cfg, _to(params, dev), max_slots=3,
                                 block_size=4, max_blocks_per_seq=8,
                                 num_blocks=13, prefill_chunk=4, device=dev,
                                 **kw)
        before = pa_kernel.launches + pa_kernel.int8_launches
        streams = []
        for wave in waves:
            ids = [eng.submit(p, 14) for p in wave]
            res = eng.run_to_completion()
            streams += [res[i] for i in ids]
        launched = pa_kernel.launches + pa_kernel.int8_launches - before
        outs.append(streams)
        m = eng.metrics()
        reports.append((m["speculative"], m["blocks"]["swapped_out_pages"],
                        m["blocks"]["host_cache_hits"],
                        m["scheduler"]["preemptions"]))
    assert outs[0] == outs[1]
    assert reports[0] == reports[1]
    assert launched == cfg.n_layers * eng.dispatches
    spec, swapped, host_hits, preemptions = reports[1]
    if kw.get("speculate"):
        assert spec["drafted_tokens"] > 0
    if kw.get("preempt") == "swap":
        assert preemptions > 0 and swapped > 0
    if kw.get("host_cache_pages"):
        assert host_hits > 0


# --- the MoE stack through the paged engine ----------------------------------

# bf16 near-tie: a stream may leave generate's only at a token where
# generate's top-2 logit gap is below this.  The engine's attention runs in
# the paged kernel and its rows in other matrix shapes than generate's
# dense path; both round to bf16 (ulp 2^-8 relative), and this model's
# logits lie within about 30, so the two paths' logits differ by up to a
# few tenths of a unit at worst.
MOE_TIE = 0.25


def test_cuda_moe_engine_exact_and_deterministic(cuda_device):
    """Reduced olmoe-1b-7b in bf16 on the card (4 experts top-2, dropless;
    output projections x8): the engine's streams equal the port's
    ``generate`` (or leave it first at a near-tie under ``MOE_TIE``, with
    at least one stream equal), the fused update launching once per layer
    and dispatch; a second engine run serves the same streams; and the
    paged step gives bit-equal logits twice over, dropless and under the
    published capacity factor 1.25 (16 rows an expert for 24 tokens):
    the MoE combine sums each token's k rows in a fixed order, with no atomics."""
    import dataclasses
    from repro_torch.config import get_config, reduced
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.serving import PagedServingEngine
    from repro_torch.serving.paged_attn import init_paged_cache, paged_step
    cfg = dataclasses.replace(reduced(get_config("olmoe-1b-7b")),
                              dtype="bfloat16")
    params = M.init_params(cfg, seed=0, device=cuda_device)
    for k in ("attn", "moe"):
        params["layers"][k]["wo"] *= 8.0
    assert params["layers"]["moe"]["router"].dtype == torch.float32
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (7, 2, 10)]
    runs = []
    for _ in range(2):
        eng = PagedServingEngine(cfg, params, max_slots=2, block_size=4,
                                 max_blocks_per_seq=8, prefill_chunk=3,
                                 token_budget=5, device=cuda_device)
        before = pa_kernel.launches
        ids = [eng.submit(p, 6) for p in prompts]
        results = eng.run_to_completion()
        assert pa_kernel.launches - before == cfg.n_layers * eng.dispatches
        runs.append([results[i] for i in ids])
    assert runs[0] == runs[1]
    exact = 0
    for got, p in zip(runs[0], prompts):
        seq, top2 = generate(cfg, params,
                             torch.from_numpy(p)[None].to(cuda_device), 6,
                             return_top2=True)
        ref = seq[0, len(p):].tolist()
        t = next((i for i in range(6) if got[i] != ref[i]), None)
        if t is None:
            exact += 1
            continue
        gap = (top2[0, t, 0] - top2[0, t, 1]).item()
        assert gap < MOE_TIE, (t, gap, got, ref)
    assert exact >= 1
    # the step twice on the same inputs: bit-equal logits
    B, S, BS = 3, 8, 4
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32)).to(cuda_device)
    pos = torch.arange(S, dtype=torch.int32,
                       device=cuda_device).expand(B, -1).contiguous()
    tables = (1 + torch.arange(B * 2, dtype=torch.int32,
                               device=cuda_device)).reshape(B, 2)
    for cf in (cfg.moe.capacity_factor, 1.25):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        outs = []
        for _ in range(2):
            cache = init_paged_cache(c, 1 + B * 2, BS, device=cuda_device)
            lg, _ = paged_step(c, params, cache, toks, pos, tables,
                               max_live_blocks=2)
            outs.append(lg)
        assert torch.isfinite(outs[0][..., :cfg.vocab].float()).all()
        assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,causal,window", [
    (1, 1100, 25, 5, True, 1024), (1, 1100, 25, 5, True, 0),
    (2, 1500, 12, 12, False, 0), (2, 448, 12, 12, True, 0)],
    ids=["hymba_window", "hymba_global", "whisper_encoder",
         "whisper_decoder"])
def test_cuda_flash_family_shapes(cuda_device, B, S, H, Hkv, causal,
                                  window, dtype):
    """The families' training shapes at D 64: hymba's 25 query heads over
    5 kv heads past a 1024-token window and on a global layer, whisper's
    encoder over 1500 frames (no mask) and its decoder.  o, lse, dq, dk
    and dv within FLASH_RTOL of the plain versions; the window dropped or
    the causal mask flipped lands outside it."""
    from repro_torch.kernels.flash_attention import kernel, ref
    q, k, v, do = flash_case(cuda_device, dtype, B, S, H, Hkv, 64, seed=4)
    opts = dict(n_q_heads=H, causal=causal, window=window)
    o, lse = kernel.flash_fwd(q, k, v, with_lse=True, **opts)
    po, plse = ref.flash_fwd(q, k, v, with_lse=True, **opts)
    dsum = (do.float() * po.float()).sum(-1)
    got = kernel.flash_bwd(q, k, v, do, plse, dsum, **opts)
    dq, dk_h, dv_h = ref.flash_bwd(q, k, v, do, plse, dsum, **opts)
    want = (dq, ref.group_sum(dk_h, H, k.shape[0]),
            ref.group_sum(dv_h, H, k.shape[0]))
    torch.cuda.synchronize()
    tol = FLASH_RTOL[dtype]
    assert _row_err(o, po) <= tol
    assert (lse - plse).abs().max() <= 1e-5 * plse.abs().max()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _row_err(a, b) <= tol, name
    wrong = [dict(opts, causal=not causal)]
    if window:
        wrong.append(dict(opts, window=0))
    for w in wrong:
        assert _row_err(ref.flash_fwd(q, k, v, **w), po) > tol


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-small",
                                  "paligemma-3b"])
def test_cuda_families_serve_and_train(cuda_device, arch):
    """Reduced hymba-1.5b, whisper-small and paligemma-3b on the card:
    fp32 greedy ``generate`` token-identical to the CPU's; in bf16 the
    flash path's loss within 1e-2 relative of plain attention's, with
    2 L forward-with-lse, L dq and L dk/dv launches over the layers that
    attend by themselves (none under paligemma's image prefix)."""
    import dataclasses
    from repro_torch.config import ShapeConfig, get_config, reduced
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.train.steps import loss_and_grads
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, seed=0, device="cpu")
    for st in [params["layers"]] + ([params["encoder"]["layers"]]
                                    if "encoder" in params else []):
        for k in ("attn", "mlp"):
            st[k]["wo"] *= 8.0
    prompts = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 7)).astype(np.int32))
    want = generate(cfg, params, prompts, 10)
    got = generate(cfg, _to(params, cuda_device), prompts.to(cuda_device),
                   10)
    assert torch.equal(got.cpu(), want)
    base = dataclasses.replace(cfg, dtype="bfloat16", remat="full",
                               scan_layers=False)
    flash = dataclasses.replace(base, use_pallas_attention=True)
    n_img = cfg.n_image_tokens or 0
    batch = {k: v.to(cuda_device) for k, v in make_batch_fn(
        cfg, ShapeConfig("t", 40 + n_img, 2, "train"))(0).items()}
    batch = {k: (v.to(torch.bfloat16) if v.is_floating_point() else v)
             for k, v in batch.items()}
    p32 = M.init_params(flash, seed=1, device=cuda_device,
                        param_dtype=torch.float32)
    L = 0 if n_img else cfg.n_layers + cfg.n_encoder_layers
    before = (kernel.fwd_lse_launches, kernel.dq_launches,
              kernel.dkv_launches)
    loss_f, _, _ = loss_and_grads(flash, p32, batch)
    torch.cuda.synchronize()
    assert (kernel.fwd_lse_launches - before[0], kernel.dq_launches
            - before[1], kernel.dkv_launches - before[2]) == (2 * L, L, L)
    loss_p, _, _ = loss_and_grads(base, p32, batch)
    assert torch.isfinite(loss_f)
    assert abs(loss_f.item() - loss_p.item()) <= 1e-2 * abs(loss_p.item())
