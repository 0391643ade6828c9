#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:

  1. print the card's name and power limit (``nvidia-smi``);
  2. build every CUDA kernel from ``src/repro_torch/kernels/*/csrc`` and
     print the build seconds and the compiler's register / spill report;
  3. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes: gemma-2b decode (S=1) and a prefill chunk
     (S=16) crossing pages, granite-3-2b GQA, a window + softcap case and
     the reduced fp32 shape, and the engine's decode bucket at batch 4 (8
     rows, 4 padded).  Live-row outputs within the stated tolerance, which
     must lie below what two known-wrong kernels give (scatter skipped,
     last page dropped); pools bit-equal after the scatter;
  4. reduced granite-3-2b in fp32: the paged engine's streams must equal
     the port's isolated greedy ``generate`` token for token, for ragged
     prompts with mid-flight admission;
  5. gemma-2b at full width (18 layers, d_model 2048, vocab 256000, bf16,
     random weights from a seed, output projections scaled so the streams
     vary) serves 4 requests (prompt 32, gen 32) through the unified
     tick.  The kernel's launch count must equal n_layers x dispatches.
     Teacher-forced on ``generate``'s tokens, the paged step's logits must
     lie within ``TF_RATIO`` times the bf16 oracle's own distance from an
     fp32 forward; the streams must match ``generate`` up to a first
     divergence where the oracle's top-2 gap is under twice the two paths'
     measured logit difference.  Then wall and device time per decode
     tick, under ``torch.profiler``;
  6. device time per call (``torch.profiler``) of the kernel, its plain
     version and one PyTorch library call (``scaled_dot_product_attention``
     over pre-gathered pages, a yardstick the port never calls) at the
     decode and prefill shapes, beside the kernel's bound;
  7. the CATopt fitness kernel against its plain version on the card: sq
     within ``FIT_RTOL`` relative at the paper's scale (E 8192, m 2048,
     P 200) and the polish's (P 4) on a ``make_problem`` instance, at two
     ragged shapes of ``test_recovery_vs_ref`` and at att < 0.  Two
     known-wrong readings (the clip dropped, the last tile of events
     dropped) must land outside the tolerance.  The autograd backward must
     match plain autograd's gradient;
  8. CATopt at the paper's scale through the five verbs (volume, problem
     on the card, instance, project sync, ``run_on_instance`` running
     ``optimize_island`` under ``GAConfig()``: population 200, 50
     generations, polish 4 x 5 steps; results; terminate).  The best
     fitness must never rise and must end below its start, the best w
     must score its fitness under the plain version, and the kernel's
     launches must equal ``1 + generations x (polish_steps + 2)`` = 351.
     Then a Monte-Carlo sweep (4096 points x 4096 steps) through
     ``SweepEngine`` over the card, every point back once and equal to
     ``sweep_vmapped``.  Then generations/s, and wall and device time per
     generation under ``torch.profiler`` with the top kernels;
  9. device time per call of the fitness kernel, its plain version and
     the library route (``torch.matmul`` + the clamp/sub/square/sum
     epilogue in torch, fp32, TF32 off) at the paper's scale and the
     polish's, beside the kernel's bound.

The last two lines are the kernel report (JSON) and
``{"ok": true, "device": {...}}``.  Without a GPU, or without the
repository around it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

FULL = 1 << 30
BRANCH_GAIN = 8.0        # phases 4, 5: see tests/test_torch_paged_serving
TF_RATIO = 2.0           # phase 5: paged logits vs fp32, in units of the
                         # bf16 oracle's own distance from fp32
# phase 3, max |kernel - plain| on live rows.  fp32: summation order.
# bf16: the kernel rounds the unnormalised p = exp(s - m) to bf16 and
# divides by l at the end, the plain version rounds the normalised
# softmax; both round the output to bf16, whose ulp is 2^-6 at |out| in
# [2, 4).  Phase 3 prints what a known-wrong kernel gives beside it.
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and op/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
KERNEL_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
KERNEL_REPLACES = "src/repro/kernels/paged_attention/kernel.py:332"
FIT_SOURCE = "src/repro_torch/kernels/recovery/csrc/fitness.cu"
FIT_REPLACES = "src/repro/kernels/recovery/kernel.py:52"
# phase 7, max |kernel - plain| / |plain| of sq: fp32 sums taken in another
# order (an fp64 reference puts the plain version within 4e-7 on
# test_recovery_vs_ref's inputs).  Phase 7 prints what a known-wrong
# reading gives beside it.
FIT_RTOL = 1e-5
GRAD_RTOL = 1e-4         # phase 7: max |grad diff| / max |grad|
PAPER = dict(E=8192, m=2048, P=200)   # catopt.make_problem, GAConfig()


def log(*a):
    print(*a, flush=True)


def phase_gpu_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    line = out.stdout.strip().splitlines()[0]
    log(line)
    return line


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build()
    secs = time.perf_counter() - t0
    log(f"[build] {len(libs)} kernel libraries in {secs:.1f} s")
    for name, lib in libs.items():
        for ln in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build] {name}: {ln.strip()}")
    return secs


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------

def make_case(torch, dev, seed, *, B, S, starts, ns, H, Hkv, D, BS, dtype):
    """Random inputs on the card for one layer's call: request b holds
    ``starts[b]`` cached tokens and ``ns[b]`` fresh ones (0 = padded row);
    pages are distinct per request, pools random everywhere."""
    g = torch.Generator(device=dev).manual_seed(seed)
    MB = max((s + n - 1) // BS + 1 for s, n in zip(starts, ns)) + 1
    NB = 1 + B * MB
    pos = torch.full((B, S), -1, dtype=torch.int32)
    tables = torch.zeros((B, MB), dtype=torch.int32)
    page = 1
    for b, (st, n) in enumerate(zip(starts, ns)):
        if n:
            pos[b, :n] = torch.arange(st, st + n, dtype=torch.int32)
            nblk = (st + n - 1) // BS + 1
            tables[b, :nblk] = torch.arange(page, page + nblk,
                                            dtype=torch.int32)
            page += nblk

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    live = int(pos.max()) // BS + 1
    return dict(q=rnd(B, S, H, D), kn=rnd(B, S, Hkv, D),
                vn=rnd(B, S, Hkv, D), kp=rnd(NB, BS, Hkv, D),
                vp=rnd(NB, BS, Hkv, D), tables=tables.to(dev),
                pos=pos.to(dev), live=live, window=FULL, softcap=0.0)


def call(fn, c):
    return fn(c["q"], c["kn"], c["vn"], c["kp"].clone(), c["vp"].clone(),
              c["tables"], c["pos"], window=c["window"],
              softcap=c["softcap"], max_live_blocks=c["live"])


def phase_kernel_vs_plain(torch, dev):
    from repro_torch.kernels.paged_attention import kernel, ref
    bf16, f32 = torch.bfloat16, torch.float32
    gemma = dict(H=8, Hkv=1, D=256, BS=16, dtype=bf16)
    granite = dict(H=32, Hkv=8, D=64, BS=16, dtype=bf16)
    cases = [
        ("gemma-2b decode S=1 B=4", dict(B=4, S=1, starts=[40, 47, 33, 63],
                                         ns=[1, 1, 1, 1], **gemma), {}),
        # the engine's decode bucket at batch 4: 8 rows, 4 of them padded
        ("gemma-2b decode S=1 B=8, 4 padded", dict(
            B=8, S=1, starts=[40, 0, 47, 0, 33, 0, 63, 0],
            ns=[1, 0, 1, 0, 1, 0, 1, 0], **gemma), {}),
        ("gemma-2b prefill S=16 B=4", dict(B=4, S=16, starts=[8, 20, 0, 40],
                                           ns=[16, 16, 11, 16], **gemma), {}),
        ("granite-3-2b GQA decode B=4", dict(B=4, S=1, starts=[5, 70, 31, 0],
                                             ns=[1, 1, 1, 0], **granite), {}),
        ("granite-3-2b GQA prefill S=16",
         dict(B=3, S=16, starts=[0, 9, 50], ns=[16, 7, 16], **granite), {}),
        ("gemma-2b window 24 + softcap 50", dict(
            B=4, S=16, starts=[30, 0, 60, 17], ns=[16, 16, 5, 1], **gemma),
         dict(window=24, softcap=50.0)),
        ("reduced fp32 D=16 G=2", dict(B=3, S=5, starts=[3, 0, 9],
                                       ns=[5, 2, 1], H=4, Hkv=2, D=16, BS=4,
                                       dtype=f32), dict(window=6)),
    ]
    worst = 0.0
    for i, (name, shape, extra) in enumerate(cases):
        c = make_case(torch, dev, 100 + i, **shape)
        c.update(extra)
        want = call(ref.unified_attention_update, c)
        got = call(kernel.paged_attention_update, c)
        torch.cuda.synchronize()
        live = c["pos"] >= 0

        def max_err(out):
            return (out.float() - want[0].float())[live].abs().max().item()

        err = max_err(got[0])
        # what a known-wrong kernel gives: the tolerance must sit below it
        wrong = {"scatter skipped": max_err(ref.paged_attention(
            c["q"], c["kp"], c["vp"], c["tables"], c["pos"],
            window=c["window"], softcap=c["softcap"],
            max_live_blocks=c["live"]))}
        if c["live"] > 1:
            wrong["last page dropped"] = max_err(call(
                ref.unified_attention_update, dict(c, live=c["live"] - 1))[0])
        tol = TOL[str(shape["dtype"]).split(".")[-1]]
        pools_equal = all(torch.equal(got[j], want[j]) for j in (1, 2))
        finite = bool(torch.isfinite(got[0].float()).all())
        log(f"[kernel] {name}: max|kernel - plain| = {err:.3e} "
            f"(tol {tol:g}; a wrong kernel: " + ", ".join(
                f"{k} {v:.3e}" for k, v in wrong.items())
            + f"), pools bit-equal {pools_equal}, finite {finite}")
        if not (err <= tol and pools_equal and finite):
            raise AssertionError(f"kernel disagrees with plain: {name}")
        if min(wrong.values()) <= tol:
            raise AssertionError(f"tolerance {tol} cannot tell a wrong "
                                 f"kernel from a right one: {name}")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def phase_reduced_exact(torch, dev):
    import numpy as np
    from repro_torch.config import get_config, reduced
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.serving import PagedServingEngine
    cfg = reduced(get_config("granite-3-2b"))
    params = M.init_params(cfg, seed=0, device="cpu")
    for k in ("attn", "mlp"):
        params["layers"][k]["wo"] *= BRANCH_GAIN
    params = tree_map(lambda t: t.to(dev), params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 8, 6, 1, 11)]
    gens = [5, 3, 9, 4, 7]
    eng = PagedServingEngine(cfg, params, max_slots=2, block_size=4,
                             max_blocks_per_seq=6, prefill_chunk=3,
                             device=dev)
    ids = [eng.submit(p, g) for p, g in zip(prompts[:2], gens[:2])]
    for _ in range(3):
        eng.step()
    ids += [eng.submit(p, g) for p, g in zip(prompts[2:], gens[2:])]
    results = eng.run_to_completion()
    min_gap = float("inf")
    for rid, p, g in zip(ids, prompts, gens):
        toks, top2 = generate(cfg, params, torch.from_numpy(p)[None].to(dev),
                              g, return_top2=True)
        ref = toks[0, len(p):].tolist()
        min_gap = min(min_gap, (top2[..., 0] - top2[..., 1]).min().item())
        if results[rid] != ref:
            raise AssertionError(f"reduced fp32: request {rid} served "
                                 f"{results[rid]}, generate gives {ref}")
    log(f"[reduced] granite-3-2b fp32: {len(ids)} requests token-identical "
        f"to generate ({eng.dispatches} ticks, smallest top-2 gap "
        f"{min_gap:.4f})")


def device_kernels(torch, prof):
    """(device us, calls, name) of every kernel and copy the profiler saw
    on the card.  Only device events: a host op's device time would count
    its kernels a second time."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            rows.append((float(us), e.count, e.key))
    return sorted(rows, reverse=True)


def profiled(torch, fn, n):
    """Run ``fn`` ``n`` times under ``torch.profiler``; device rows."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return device_kernels(torch, prof)


def teacher_forced(torch, dev, cfg, params, seq, P, BS):
    """Logits of the token sequences ``seq`` (B, T) three ways: through
    the paged step on the kernel (the prompt in chunks of BS, then one
    token per step, as the engine feeds them), through the dense bf16
    ``forward`` the oracle uses, and through ``forward`` in fp32.  Returns
    max |paged - bf16|, max |paged - fp32|, max |bf16 - fp32|."""
    import dataclasses
    from repro_torch.models import model as M
    from repro_torch.models.layers import logits_from_hidden
    from repro_torch.serving.paged_attn import init_paged_cache, paged_step
    B, T = seq.shape
    MB = -(-T // BS)
    cache = init_paged_cache(cfg, 1 + B * MB, BS, device=dev)
    tables = (1 + torch.arange(B * MB, dtype=torch.int32,
                               device=dev)).reshape(B, MB)
    chunks = [(s, min(s + BS, P)) for s in range(0, P, BS)]
    chunks += [(t, t + 1) for t in range(P, T)]
    paged = []
    for a, b in chunks:
        pos = torch.arange(a, b, dtype=torch.int32,
                           device=dev).expand(B, -1).contiguous()
        lg, cache = paged_step(cfg, params, cache, seq[:, a:b], pos, tables,
                               max_live_blocks=(b - 1) // BS + 1)
        paged.append(lg.float())
    paged = torch.cat(paged, dim=1)[..., :cfg.vocab]
    del cache

    def dense(c, p):
        return logits_from_hidden(p, M.forward(c, p, {"tokens": seq}),
                                  c).float()[..., :cfg.vocab]

    bf16 = dense(cfg, params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    f32 = dense(cfg32, p32)
    del p32
    return ((paged - bf16).abs().max().item(),
            (paged - f32).abs().max().item(),
            (bf16 - f32).abs().max().item())


def tick_breakdown(torch, cfg, params, prompts, G, kw, ticks=8):
    """Wall and device busy time per decode tick (4 requests decoding),
    and the kernels that take the most device time."""
    from repro_torch.serving import PagedServingEngine
    eng = PagedServingEngine(cfg, params, **kw)
    for row in prompts:
        eng.submit(row, G)
    for _ in range(4):                 # prefill and the first decode ticks
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / ticks * 1e3
    rows = profiled(torch, eng.step, ticks)
    busy = sum(r[0] for r in rows) / ticks / 1e3
    log(f"[tick] gemma-2b decode B={len(prompts)}: wall {wall:.3f} ms/tick, "
        f"device busy {busy:.3f} ms/tick, idle share {1 - busy / wall:.3f}")
    for us, n, key in rows[:12]:
        log(f"[tick]   {us / ticks / 1e3:.4f} ms x{n // ticks}  {key[:90]}")


def phase_full_width(torch, dev):
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.serving import PagedServingEngine
    cfg = get_config("gemma-2b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device=dev)
    # gemma scales the embedding by sqrt(d_model), and with tied random
    # embeddings the last token's own logit (~ d_model) beats every other
    # (~ 5 sqrt(d_model)) unless the branches dwarf it: scale both output
    # projections by sqrt(d_model) and by phase 4's gain, so that
    # attention and MLP decide each greedy token
    gain = BRANCH_GAIN * cfg.d_model ** 0.5
    for k in ("attn", "mlp"):
        params["layers"][k]["wo"].mul_(gain)
    torch.cuda.synchronize()
    log(f"[full] gemma-2b: {M.count_params(cfg) / 1e9:.3f} B parameters "
        f"({cfg.dtype}) initialised in {time.perf_counter() - t0:.1f} s, "
        f"output projections x{gain:.2f}")
    B, P, G, BS = 4, 32, 32, 16
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (B, P),
                                                dtype=np.int32)
    kw = dict(max_slots=B, block_size=BS, max_blocks_per_seq=-(-(P + G) // BS),
              device=dev)
    warm = PagedServingEngine(cfg, params, **kw)        # cuBLAS, build, caches
    warm.submit(prompts[0], 4)
    warm.run_to_completion()
    del warm
    eng = PagedServingEngine(cfg, params, **kw)
    torch.cuda.synchronize()
    kernel.launches = 0
    t0 = time.perf_counter()
    ids = [eng.submit(row, G) for row in prompts]
    results = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    n_tok = sum(len(v) for v in results.values())
    sched = eng.metrics()["scheduler"]
    log(f"[full] served {B} requests x {G} tokens in {eng.dispatches} ticks, "
        f"{wall:.3f} s: {n_tok / wall:.1f} tokens/s, p50 TTFT "
        f"{sched['p50_ttft_s']}, kernel launches {launches} "
        f"(n_layers {cfg.n_layers} x dispatches {eng.dispatches} = "
        f"{cfg.n_layers * eng.dispatches})")
    if launches != cfg.n_layers * eng.dispatches or launches == 0:
        raise AssertionError("the main path did not run through the kernel "
                             "once per layer per tick")
    seq, top2 = generate(cfg, params, torch.from_numpy(prompts).to(dev), G,
                         return_top2=True)
    toks = seq[:, P:].cpu().tolist()
    top2 = top2.cpu()
    distinct = [len(set(row)) for row in toks]
    log(f"[full] generate: distinct tokens per stream {distinct}, smallest "
        f"top-2 logit gap {(top2[..., 0] - top2[..., 1]).min().item():.4f}")
    if min(distinct) <= 1:
        raise AssertionError("full width: a stream repeats one token; it "
                             "cannot tell a wrong attention")
    # teacher-forced: the paged step's logits on generate's own tokens
    tf_err, paged_err, own_err = teacher_forced(torch, dev, cfg, params,
                                                seq, P, BS)
    log(f"[full] teacher-forced logits over {B}x{P + G} positions: "
        f"max|paged - generate's bf16| {tf_err:.4f}; against fp32: paged "
        f"{paged_err:.4f}, generate's bf16 {own_err:.4f} (allowed "
        f"{TF_RATIO:g}x)")
    if not paged_err <= TF_RATIO * own_err:
        raise AssertionError("full width: the paged step's logits are "
                             "further from fp32 than bf16 rounding explains")
    # a stream may leave generate's only where the oracle's top two
    # logits are within the two paths' measured logit difference of each
    # other: then rounding alone can swap them
    allowed = 2 * tf_err
    exact = 0
    for b, rid in enumerate(ids):
        got, ref = results[rid], toks[b]
        t = next((i for i in range(G) if got[i] != ref[i]), None)
        if t is None:
            exact += 1
            log(f"[full] request {rid}: {G} tokens identical to generate")
            continue
        gap = (top2[b, t, 0] - top2[b, t, 1]).item()
        log(f"[full] request {rid}: first divergence at token {t}: oracle "
            f"top-2 gap {gap:.4f} (allowed < {allowed:.4f})")
        if not gap < allowed:
            raise AssertionError(f"full width: request {rid} diverges at "
                                 f"token {t} with a clear top-2 gap {gap}")
    log(f"[full] {exact}/{B} streams identical to generate")
    tick_breakdown(torch, cfg, params, prompts, G, kw)
    return launches, n_tok / wall


# ---------------------------------------------------------------------------
# phase 6: timing
# ---------------------------------------------------------------------------

def device_ms(torch, fn, reps=50, warmup=5):
    """Device milliseconds per call: the summed device time of every
    kernel and copy ``fn`` puts on the card (``torch.profiler``), over
    ``reps`` calls.  The host's time to issue them is not in it."""
    for _ in range(warmup):
        fn()
    return sum(r[0] for r in profiled(torch, fn, reps)) / reps / 1e3


def bound(torch, c):
    """Least time for the call's work on an H100 SXM: each byte the
    function needs read once and each output byte written once, or the
    operations the live query rows need (4*D per key: QK and PV) at the
    input type's peak, whichever is larger.  Bytes: the cached K/V rows
    the queries reach (those before a request's first fresh position,
    within the window), q in and out, the live fresh rows in and into the
    pools, the tables and positions; padded rows move no K/V."""
    B, S, H, D = c["q"].shape
    Hkv = c["kn"].shape[2]
    item = c["q"].element_size()
    pos = c["pos"].long()
    live = pos >= 0
    n_fresh = int(live.sum())
    first = torch.where(live, pos, FULL).min(dim=1).values
    first = torch.where(live.any(dim=1), first, 0)
    cached = first - (first - c["window"] + 1).clamp(min=0)
    nbytes = (2 * int(cached.sum()) * Hkv * D * item     # cached K, V read
              + 2 * B * S * H * D * item                 # q in, out
              + 2 * 2 * n_fresh * Hkv * D * item         # fresh rows in+out
              + 4 * (c["tables"].numel() + c["pos"].numel()))
    keys = (pos + 1).clamp(min=0, max=c["window"])       # keys per query row
    ops = 4 * D * H * int(keys.sum())
    dt = str(c["q"].dtype).split(".")[-1]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import kernel, ref
    gemma = dict(H=8, Hkv=1, D=256, BS=16, dtype=torch.bfloat16)
    shapes = {"decode": dict(B=4, S=1, starts=[48, 52, 60, 63],
                             ns=[1, 1, 1, 1], **gemma),
              "prefill": dict(B=4, S=16, starts=[16, 0, 32, 48],
                              ns=[16, 16, 16, 16], **gemma)}
    out = {}
    for label, shape in shapes.items():
        c = make_case(torch, dev, 7, **shape)
        kp, vp = c["kp"].clone(), c["vp"].clone()

        def run(fn):
            return lambda: fn(c["q"], c["kn"], c["vn"], kp, vp, c["tables"],
                              c["pos"], window=FULL, softcap=0.0,
                              max_live_blocks=c["live"])

        ms = device_ms(torch, run(kernel.paged_attention_update))
        plain_ms = device_ms(torch, run(ref.unified_attention_update))
        # the library yardstick: SDPA on the same keys, pages pre-gathered
        B, S, H, D = c["q"].shape
        L = c["live"] * shape["BS"]
        k = kp[c["tables"][:, :c["live"]].long()].reshape(B, L, 1, D)
        v = vp[c["tables"][:, :c["live"]].long()].reshape(B, L, 1, D)
        qpos = c["pos"].long()
        mask = (torch.arange(L, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]              # (B, 1, S, L)
        qt = c["q"].transpose(1, 2)
        kt = k.transpose(1, 2).expand(B, H, L, D)           # MQA: one head
        vt = v.transpose(1, 2).expand(B, H, L, D)
        library_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        bound_ms, bound_by = bound(torch, c)
        out[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        log(f"[time] {label} {tuple(c['q'].shape)} bf16, device time per "
            f"call: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
            f"{library_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
    return out


# ---------------------------------------------------------------------------
# phase 7: the fitness kernel against its plain version
# ---------------------------------------------------------------------------

def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def fitness_cases(torch, dev, problem):
    """(name, il, w, target, att, limit) at the main path's shapes on the
    paper's problem, and at test_recovery_vs_ref's ragged shapes.  On the
    problem, row p of w is uniform times a scale from 0 to 0.3, so the
    rows' losses run from below the attachment to far above the limit
    and both clips and the live band all carry weight."""
    g = torch.Generator(device=dev).manual_seed(5)
    il, target = problem.industry_losses, problem.target_recovery
    E, m = il.shape

    def pop(P):
        scale = torch.linspace(0.0, 0.3, P, device=dev)[:, None]
        return torch.rand((P, m), generator=g, device=dev) * scale

    def recovery_case(E, m, P):
        return (torch.randn((E, m), generator=g, device=dev).abs(),
                torch.rand((P, m), generator=g, device=dev),
                torch.randn(E, generator=g, device=dev).abs())

    cases = [(f"paper scale E {E} m {m} P {PAPER['P']}", il, pop(PAPER["P"]),
              target, problem.attachment, problem.limit),
             (f"polish E {E} m {m} P 4", il, pop(4), target,
              problem.attachment, problem.limit)]
    for E_, m_, P_, att, limit in ((500, 300, 37, 5.0, 20.0),
                                   (1024, 256, 8, 5.0, 20.0),
                                   (500, 300, 37, -4.0, 124.0)):
        il_, w_, t_ = recovery_case(E_, m_, P_)
        cases.append((f"E {E_} m {m_} P {P_} att {att:g} limit {limit:g}",
                      il_, w_, t_, att, limit))
    return cases


def phase_fitness_vs_plain(torch, dev, problem):
    """Returns (max abs error of sq at the paper's scale, max relative
    error of sq over all cases)."""
    from repro_torch.kernels.recovery import kernel, ops, ref
    worst_rel, paper_abs = 0.0, None
    for name, il, w, target, att, limit in fitness_cases(torch, dev,
                                                         problem):
        got = kernel.fitness_sq(il, w, target, att, limit)
        want = ref.fitness_sq(il, w, target, att, limit)
        sync(torch, dev)

        def rel(x):
            return ((x - want).abs() / want.abs()).max().item()

        err = rel(got)
        E = il.shape[0]
        cut = (E - 1) // kernel.BLOCK_EVENTS * kernel.BLOCK_EVENTS
        wrong = {"clip dropped": rel(torch.square(
                     torch.matmul(w, il.T) - att - target).sum(-1)),
                 "last event tile dropped": rel(ref.fitness_sq(
                     il[:cut], w, target[:cut], att, limit))}
        finite = bool(torch.isfinite(got).all())
        log(f"[fitness] {name}: max|kernel - plain|/|plain| = {err:.3e} "
            f"(tol {FIT_RTOL:g}; a wrong kernel: " + ", ".join(
                f"{k} {v:.3e}" for k, v in wrong.items())
            + f"), finite {finite}")
        if not (err <= FIT_RTOL and finite):
            raise AssertionError(f"fitness kernel disagrees with plain: "
                                 f"{name}")
        if min(wrong.values()) <= FIT_RTOL:
            raise AssertionError(f"tolerance {FIT_RTOL} cannot tell a wrong "
                                 f"kernel from a right one: {name}")
        if paper_abs is None:
            paper_abs = (got - want).abs().max().item()
        worst_rel = max(worst_rel, err)
    # the backward: the autograd Function against plain autograd, on the
    # polish's shape with rows spread over the live band, and a budget no
    # row reaches, so the gradient is the fitness's alone
    il, target = problem.industry_losses, problem.target_recovery
    w = torch.rand((4, il.shape[1]), generator=torch.Generator(
        device=dev).manual_seed(6), device=dev)
    w = w * torch.tensor([0.02, 0.05, 0.1, 0.2], device=dev)[:, None]
    budget = 2 * float(w.sum(-1).max())
    grads = []
    for fn in (ops.basis_risk, ref.basis_risk):
        wt = w.clone().requires_grad_(True)
        fn(il, target, wt, problem.attachment, problem.limit,
           budget).sum().backward()
        grads.append(wt.grad)
    sync(torch, dev)
    gerr = ((grads[0] - grads[1]).abs().max()
            / grads[1].abs().max()).item()
    log(f"[fitness] backward (4, {il.shape[1]}): max|grad - plain grad| / "
        f"max|plain grad| = {gerr:.3e} (tol {GRAD_RTOL:g})")
    if not gerr <= GRAD_RTOL:
        raise AssertionError("fitness backward disagrees with plain autograd")
    return paper_abs, worst_rel


# ---------------------------------------------------------------------------
# phase 8: CATopt through the five verbs, and a Monte-Carlo sweep
# ---------------------------------------------------------------------------

def ga_breakdown(torch, dev, problem, cfg, gens=5):
    """Wall and device busy time per GA generation at the paper's scale,
    and the kernels that take the most device time."""
    from repro_torch.core import catopt
    gen = torch.Generator(device=dev).manual_seed(9)
    draws = catopt.Draws(gen, cfg.pop_size, problem.n_dims, cfg, dev)
    arrays = problem.arrays()
    with torch.no_grad():
        pop = catopt._init_pop(gen, cfg.pop_size, problem.n_dims, dev)
        carry = (pop, catopt.basis_risk(problem, pop))

        def step():
            nonlocal carry
            carry, _ = catopt._ga_generation(arrays, cfg, carry, draws(0))

        step()
        sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(gens):
            step()
        sync(torch, dev)
        wall = (time.perf_counter() - t0) / gens * 1e3
        rows = profiled(torch, step, gens)
    busy = sum(r[0] for r in rows) / gens / 1e3
    log(f"[catopt] generation (P {cfg.pop_size}, polish {cfg.polish_k} x "
        f"{cfg.polish_steps}): wall {wall:.3f} ms, device busy {busy:.3f} "
        f"ms, idle share {1 - busy / wall:.3f}")
    for us, n, key in rows[:10]:
        log(f"[catopt]   {us / gens / 1e3:.4f} ms x{n // gens}  {key[:90]}")


def mc_price(pt):
    """examples/param_sweep.py's Monte-Carlo option price for one sweep
    point, its noise given with the point."""
    import torch
    path = torch.exp(torch.cumsum(pt["z"] * pt["sigma"] + pt["drift"], 0)
                     * 0.001)
    return {"price": torch.clamp(path[-1] - 1.0, min=0.0), "idx": pt["idx"]}


def phase_sweep(torch, dev, n=4096, steps=4096):
    import numpy as np
    from repro_torch.core.sweep import SweepEngine, sweep_vmapped
    g = torch.Generator(device=dev).manual_seed(11)
    pts = {"z": torch.randn((n, steps), generator=g, device=dev),
           "sigma": torch.linspace(0.1, 2.0, n, device=dev),
           "drift": torch.linspace(-0.5, 0.5, n, device=dev),
           "idx": torch.arange(n, device=dev)}
    fast = sweep_vmapped(mc_price, pts, device=dev)
    engine = SweepEngine(None if dev.type == "cuda" else [dev],
                         placement="bynode", over_decompose=4)
    out = engine.run(mc_price, pts)
    rep = engine.last_report
    want = fast["price"].cpu().numpy()
    diff = float(np.abs(out["price"] - want).max())
    log(f"[sweep] {n} points x {steps} steps on {len(engine.devices)} "
        f"device(s): {rep.n_tasks} tasks, {rep.n_stolen} stolen, "
        f"{rep.n_speculated} speculated, wall {rep.wall_time:.3f} s; "
        f"max|engine - vmapped| {diff:.3e}, mean price {want.mean():.4f}")
    if not np.array_equal(out["idx"], np.arange(n)):
        raise AssertionError("sweep: a point is missing or repeated")
    if sum(rep.device_task_counts.values()) != rep.n_tasks:
        raise AssertionError("sweep: a task came back twice or not at all")
    np.testing.assert_allclose(out["price"], want, rtol=1e-5, atol=1e-6)
    if not np.isfinite(want).all() or not (want > 0).any():
        raise AssertionError("sweep: prices are not finite and positive")


def phase_catopt(torch, dev, problem):
    """CATopt at the paper's scale through the five verbs.  Returns the
    fitness kernel's launches in the run and generations/s."""
    import numpy as np
    from repro_torch.core.catopt import GAConfig, optimize_island, \
        problem_from_numpy
    from repro_torch.core.platform import Platform
    from repro_torch.core.resources import DevicePool
    from repro_torch.kernels.recovery import kernel, ref
    cfg = GAConfig()
    ws = os.path.join(HERE, "build", "chip_smoke_platform")
    shutil.rmtree(ws, ignore_errors=True)
    try:
        platform = Platform(ws, pool=None if dev.type == "cuda"
                            else DevicePool([dev]))
        vol = platform.create_volume()                              # 1
        t0 = time.perf_counter()
        vol.put("catopt_problem", {                                 # 2
            "il": problem.industry_losses,
            "target": problem.target_recovery,
            "scalars": np.array([problem.attachment, problem.limit,
                                 problem.weight_budget])})
        put_s = time.perf_counter() - t0
        platform.create_instance("catopt", volume=vol.volume_id)   # 3
        stats = platform.send_data_to_cluster(                      # 4
            "catopt", project={"seed": np.array(1)})

        def job(ctx):
            d = ctx.volume.get("catopt_problem")
            att, limit, budget = d["scalars"].tolist()
            prob = problem_from_numpy(d["il"], d["target"], att, limit,
                                      budget, device=ctx.cluster.master)
            if not torch.equal(prob.industry_losses,
                               problem.industry_losses):
                raise AssertionError("the volume did not give the problem "
                                     "back")
            sync(torch, dev)
            t0 = time.perf_counter()
            res = optimize_island(prob, cfg, seed=int(ctx.project["seed"]),
                                  device=ctx.cluster.master)
            sync(torch, dev)
            wall = time.perf_counter() - t0
            ctx.save_result("catopt", {"w": res["w"],
                                       "history": res["history"]})
            return {"fitness": float(res["fitness"]), "wall_s": wall,
                    "history": res["history"].tolist()}

        kernel.launches = 0
        h = platform.run_on_instance("catopt", job,                 # 5
                                     runname="catopt-paper")
        launches = kernel.launches
        saved = np.load(os.path.join(platform.get_results("catopt-paper"),
                                     "catopt.npz"))                 # 6
        platform.terminate_cluster("catopt", delete_volume=True)   # 7
    finally:
        shutil.rmtree(ws, ignore_errors=True)
    hist = np.array(h.result["history"])
    w = torch.from_numpy(saved["1"]).to(dev)            # leaves: history, w
    plain = float(ref.basis_risk(problem.industry_losses,
                                 problem.target_recovery, w[None],
                                 problem.attachment, problem.limit,
                                 problem.weight_budget)[0])
    expect = 1 + cfg.generations * (cfg.polish_steps + 2)
    gens_s = cfg.generations / h.result["wall_s"]
    log(f"[catopt] E {problem.n_events} m {problem.n_dims}, pop "
        f"{cfg.pop_size}, {cfg.generations} generations: volume put "
        f"{put_s:.2f} s, sync sent {stats.entries_sent} entries; GA "
        f"{h.result['wall_s']:.3f} s = {gens_s:.2f} generations/s; best "
        f"fitness {hist[0]:.4f} -> {hist[-1]:.4f} (plain version on the "
        f"saved w: {plain:.4f}); kernel launches {launches} (1 + "
        f"generations {cfg.generations} x (polish_steps {cfg.polish_steps}"
        f" + 2) = {expect})")
    if not (np.diff(hist) <= 0).all() or not hist[-1] < hist[0]:
        raise AssertionError("CATopt: the best fitness rose, or never fell")
    if not np.array_equal(saved["0"], hist):
        raise AssertionError("CATopt: get_results does not hold the run's "
                             "history")
    if not abs(plain - h.result["fitness"]) <= 1e-4 * plain:
        raise AssertionError("CATopt: the best w does not score its fitness")
    if launches != expect:
        raise AssertionError("CATopt: the GA did not run through the kernel "
                             "once per fitness call")
    phase_sweep(torch, dev)
    ga_breakdown(torch, dev, problem, cfg)
    return launches, gens_s


# ---------------------------------------------------------------------------
# phase 9: fitness timing
# ---------------------------------------------------------------------------

def fitness_bound(E, m, P):
    """Least time for the call on an H100 SXM: IL, w and target read once
    and sq written once at the HBM rate, or the matrix product's 2 E m P
    operations plus the epilogue's (subtract, two compares, subtract,
    square, add: 6 per event and individual) at the fp32 peak, whichever
    is larger."""
    nbytes = 4 * (E * m + P * m + E + P)
    ops = 2 * E * m * P + 6 * E * P
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_fitness_timing(torch, dev, problem):
    from repro_torch.kernels.recovery import kernel, ref
    il, target = problem.industry_losses, problem.target_recovery
    att, limit = problem.attachment, problem.limit
    g = torch.Generator(device=dev).manual_seed(12)
    out = {}
    for label, P in (("paper", PAPER["P"]), ("polish", 4)):
        w = torch.rand((P, il.shape[1]), generator=g, device=dev) * 0.1

        def library():
            loss = torch.matmul(w, il.T)
            return torch.square(torch.clamp(loss - att, 0.0, limit)
                                - target).sum(-1)

        ms = device_ms(torch, lambda: kernel.fitness_sq(il, w, target, att,
                                                        limit))
        plain_ms = device_ms(torch, lambda: ref.fitness_sq(il, w, target,
                                                           att, limit))
        library_ms = device_ms(torch, library)
        bound_ms, bound_by = fitness_bound(il.shape[0], il.shape[1], P)
        out[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        log(f"[time] fitness {label} E {il.shape[0]} m {il.shape[1]} P {P} "
            f"fp32, device time per call: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, matmul + epilogue {library_ms:.4f} ms, "
            f"bound {bound_ms:.6f} ms ({bound_by})")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    gpu = phase_gpu_info()
    phase_build()
    max_err = phase_kernel_vs_plain(torch, dev)
    phase_reduced_exact(torch, dev)
    launches, tok_s = phase_full_width(torch, dev)
    timing = phase_timing(torch, dev)
    from repro_torch.core.catopt import make_problem
    problem = make_problem(seed=0, n_events=PAPER["E"], n_dims=PAPER["m"],
                           device=dev)
    fit_abs, fit_rel = phase_fitness_vs_plain(torch, dev, problem)
    fit_launches, _ = phase_catopt(torch, dev, problem)
    fit = phase_fitness_timing(torch, dev, problem)["paper"]
    dec = timing["decode"]
    report = {"kernels": [{
        "name": "paged_attention_update", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": max_err,
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"]}, {
        "name": "fitness_sq", "route": "cuda",
        "source": FIT_SOURCE, "replaces": FIT_REPLACES,
        "launches": fit_launches, "max_abs_err": fit_abs,
        "max_rel_err": fit_rel,
        "ms": fit["ms"], "plain_ms": fit["plain_ms"],
        "bound_ms": fit["bound_ms"], "bound_by": fit["bound_by"],
        "library_ms": fit["library_ms"]}]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {gpu}")
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
