"""The port's CUDA kernel on the card, against its plain PyTorch version.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false (the kernel has no CPU mode).  The
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
