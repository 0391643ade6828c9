#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --timing-only [--src DIR]

The second form runs phases 1, 6, 6b, 9 and 15, a GA-generation breakdown
and two decode-tick breakdowns (fp and int8 pages) alone, on the
``repro_torch`` package under ``DIR``
(default: this repository's ``src``): run it on the parent's tree and on
this one in one call (parent, change, change, parent) to compare them on
one card.

Phases, each raising on failure:

  1. print the card's name and power limit (``nvidia-smi``);
  2. build every CUDA kernel from ``src/repro_torch/kernels/*/csrc`` and
     print the build seconds and the compiler's register / spill report;
  3. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes: gemma-2b decode (S=1) and a prefill chunk
     (S=16) crossing pages, granite-3-2b GQA, a window + softcap case and
     the reduced fp32 shape, the engine's decode bucket at batch 4 (8
     rows, 4 padded), pages of 4 rows (four pages a split of the walk) and
     a fresh page past ``max_live_blocks``.  Live-row outputs within the
     stated tolerance, which must lie below what two known-wrong kernels
     give (scatter skipped, last page dropped); pools bit-equal after the
     scatter;
  3b. the rest of the paged-attention family against its plain versions
     at the main paths' shapes: the fused update over int8 pools (gemma-2b
     decode, the decode bucket, the prefill bucket, window + softcap,
     granite-3-2b GQA at D 64, reduced fp32, pages of 4 rows, a fresh page
     past the walk), K/V and scale pools (quantized in the kernel)
     bit-equal, outputs within the tolerance, which must lie below a walk
     that skips the scales and one that skips the scatter; the read-only
     walk over fp and int8 pools, pools unchanged, below a walk that drops
     the last page (or skips the scales); the fused update, fp and int8
     pools, at the verify-chain shapes of speculative decoding (S = 2, 4,
     5 rows a request, and the unified tick's S = 8 view of 5-row chains;
     ragged chains crossing pages), pools bit-equal, below a walk that
     skips the scatter and one without the causal mask inside the chain;
     the walk at head_dim 128, split over pages (the fused update over fp
     and int8 pools and the read-only walk over both) at glm4-9b's decode
     (B 4, 32 heads over 2 kv heads), olmoe-1b-7b's prefill chunk crossing
     pages (16 heads, 16 kv heads) and grok-1-314b's GQA (48 over 8) with
     softcap 30, below a walk that skips the scatter, drops the last page
     or skips the scales, pools bit-equal; copy_page on bf16, int8 and
     fp32 scale pools with host and device ids, the destination bit-equal
     to the source in every layer, every other page untouched, a copy
     that stops at layer 0 reading above 0, and bad device ids setting
     the error flag; copy_pages over gemma-2b's whole cache (fp: K, V;
     int8: K, V and their scale pools) in one launch, host and device
     ids, every pool's destination bit-equal, beside a copy that stops at
     layer 0 and one that skips the last pool, and bad device ids moving
     nothing in any pool; each paged and copy instantiation's registers
     and spills;
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
     measured logit difference.  Then wall and device time and launches
     per decode tick, fp and int8 pages, under ``torch.profiler``;
  5b. gemma-2b at full width through the engine's ported options, each
     run with the launch counts set to 0 just before it: int8 pages (the
     int8 update's launches must equal n_layers x ticks, every request
     finishes); the unified and the two-dispatch tick (streams equal);
     the prefix cache on a 48-token system prompt with distinct 112-token
     suffixes and one prompt repeated in full (streams byte-equal to the
     cache off, hits, one copy_pages launch per copy-on-write copy, every
     pool of the cache in it; so on every path below).  Over the pools the
     int8 and fp runs filled, mid-decode, the read-only walk (the public
     ``paged_attn.paged_attention``) against its plain version.  Then,
     each run with the counts set to 0 just before it and the update
     launching once per layer per pass: speculative decoding (4 requests,
     prompt 32, generate 32, ``draft_k`` 4) on both ticks over fp pages,
     and on the unified tick over int8 pages with the prefix cache (a
     re-served prompt: copy_page under speculation), logging drafts,
     accept rate and tokens a pass; ``preempt="swap"`` in 12 usable pages
     (swapped pages above 0, every parked payload equal to its pages and
     every restored page bit-equal to its payload, ms a page out and in);
     each stream equal to the non-speculative run's or leaving it first
     at a near-tie (top-2 margin under ``SPEC_TIE``, the paged step one
     token a step); and the prefix cache's host tier (one slot, chunks of
     3, two prompts sharing a 48-token system prompt in a pool of one
     request's pages, the first re-served): host restores above 0,
     restored pages bit-equal to the spilled bytes, streams byte-equal to
     the cache off;
  5c. gemma-2b at full width through the serving stack's other entry
     points, each run with the launch counts set to 0 just before it:
     (a) the legacy dense engine (``core.serving.ServingEngine``), 4 x
     (prompt 32 + generate 32), prefill token by token, no paged kernel
     launched, streams equal to ``generate`` or leaving it first at a
     near-tie (``SPEC_TIE``; prefill token by token rounds otherwise than
     one pass), tokens/s; (b) ``launch/serve --open-loop --mix chat
     --arrivals poisson --rate 20 --requests 32 --seed 0`` (the CLI's
     ``run`` on phase 5's weights) over the paged engine on the wall
     clock: TTFT p50/p99, TPOT, goodput at a 0.5 s TTFT / 0.05 s TPOT
     SLO, ``overlap_admitted``, one update launch per tick and layer,
     streams held to the closed-loop engine's under the same near-tie
     rule; (c) ``--mix agents --prefix-cache --host-cache-pages 16
     --replicas 2`` under ``--routing affinity`` and ``rr`` (two replicas
     on the one card, one weight set): placements,
     ``affinity_hit_tokens`` (above 0 under affinity), one update launch
     per replica tick and layer, streams held to one engine's; then the
     same traffic with a replica failed at tick 10 (the router's injected
     preemption calls ``fail_replica``): every request re-routed with
     exactly its tokens; (d) ``--engine batch --temperature 0.7`` twice
     from the same seed: the sampled streams equal, and not greedy's;
  5d. olmoe-1b-7b at full width (16 layers, d_model 2048, 16 heads of
     128, 64 experts top-8, d_ff 1024, vocab 50304, bf16, random weights
     from seed 0, output projections scaled as in phase 5) serves 4
     requests (prompt 32, gen 32) through the unified tick, each run with
     the launch counts set to 0 just before it.  Under the dropless
     override (``capacity_factor`` E / k = 8, so every expert's buffer
     holds every token): fp pages, then int8 pages, the head_dim-128
     update launching n_layers x dispatches, the read-only walk over the
     filled pools held to its plain version; the fp streams and
     teacher-forced logits held as in phase 5; the prefix cache on phase
     5b's shared prompt (streams byte-equal to the cache off, one
     copy_pages launch a copy-on-write).  Under the published
     ``capacity_factor`` 1.25: every request finishes, the share of
     assignments dropped (a side call on the routing), and a decode tick
     under ``torch.profiler``, split into the walk, the expert products
     and the rest, beside the expert weights' bytes over HBM.  Then the
     same weights cast to fp32 (dropless): the engine over fp32 pages,
     the fp32 walk once per layer per tick, every stream identical to
     fp32 ``generate``'s (or leaving it at a top-2 gap under
     ``FP32_TIE``), teacher-forced logits within ``FP32_TF`` of the fp32
     forward's largest; in bf16 the two paths route some tokens to other
     experts at near-ties, which the bf16 checks must allow for;
  5e. glm4-9b (40 layers, d 4096, 32 heads over 2 kv heads of 128,
     partial RoPE), gemma3-4b (34 layers, d 2560, head_dim 256, a
     1024-token window on five layers of six; prompts of 1100 tokens) and
     grok-1-314b (full width, d 6144, 48 heads over 8 of 128, softcap 30,
     8 experts top-2 with GeGLU, tied embeddings; depth cut from 64 to 2
     layers, one card holding about 7) at full width, 4 requests over fp
     pages, each with the counts set to 0 just before it: the update
     launches once per layer per tick, the streams and teacher-forced
     logits held as in phase 5 (grok under the dropless override), a
     decode tick's breakdown, then 5d's fp32 checks.  Each of 5d and 5e
     logs its seconds and peak memory and frees its weights;
  6. device time per call (the median of CUDA events around each call,
     behind a queued sleep) of the kernel, its plain version and one
     PyTorch library call (``scaled_dot_product_attention`` over
     pre-gathered pages, a yardstick the port never calls) at gemma-2b's
     decode and prefill shapes and glm4-9b's decode at head_dim 128,
     beside the kernel's bound;
  6b. the same for the int8 update (decode, prefill, glm4-9b decode),
     against SDPA over pages gathered and dequantized beforehand and
     against the gather, the dequantize and SDPA all timed, the read-only
     walk over fp and int8 pools (gemma-2b and glm4-9b decode), copy_page
     on gemma-2b's K pool against ``index_copy_``, and one copy-on-write
     over gemma-2b's whole cache (fp and int8 pages) through the engine's
     ``_copy_page``: launches, device ms, host us a COW, against
     ``index_copy_`` on each pool;
  7. the CATopt fitness kernel against its plain version on the card: sq
     within ``FIT_RTOL`` relative at the paper's scale (E 8192, m 2048,
     P 200) and the polish's (P 4) on a ``make_problem`` instance, at two
     ragged shapes of ``test_recovery_vs_ref``, at att < 0 and at narrow
     ragged shapes (P 3, 5).  Every call that takes the narrow kernel
     (P <= 8) gives rows bit-equal to the wide kernel's on the same rows.
     Known-wrong readings (the clip dropped, the last tile of events
     dropped, and for the wide kernel the last 8 columns of each tile of
     ``BLOCK_INDIVIDUALS`` dropped) must land outside the tolerance.  The
     autograd backward must match plain autograd's gradient;
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
  9. each fitness instantiation's registers and spills (the ptxas log),
     then device time per call (CUDA events) of the fitness kernel, its
     plain version and the library route (``torch.matmul`` + the
     clamp/sub/square/sum epilogue in torch, fp32, TF32 off) at the
     paper's scale and the polish's, beside the kernel's bound;
  10. the flash-attention kernels (forward without and with lse, dq,
     dk/dv; bf16 on the tensor cores, fp32 scalar) against their plain
     versions, fp32 and bf16: granite-3-2b's heads at both training
     shapes, gemma MQA at D 256, D 128 with a ragged S, a 32-token
     window, softcap 30, non-causal, the launcher's D 40, and the bf16
     tiling's edges (S 65 under window and softcap, D 20 with 8-byte
     copies, an odd D 33 with plain loads); and the families' training
     shapes (hymba-1.5b's 25 heads over 5 at 1 x 2048 with its
     1024-token window and without, whisper-small's encoder 4 x 1500
     non-causal and decoder 4 x 448; bf16 only at S >= 1500 and for
     hymba).  Each row (a query's o or dq, a key's dk or dv) within
     ``FLASH_TOL`` relative of the plain row, below what known-wrong
     kernels give (the causal mask flipped; the window dropped; the last
     query tile's last or middle 64 keys of its band dropped; no softcap
     factor in the backward; dk, dv of one query head, not
     group-summed); the backward bit-equal across calls;
  11. granite-3-2b at full width (40 layers, d 2048, vocab 49155, bf16
     compute, fp32 masters and AdamW states, remat full) on the flash
     path through ``loss_and_grads`` and ``make_train_step``: the first
     step's loss and grads against plain attention (grads within
     ``GRAD_RATIO`` times the plain path's distance from fp32, a 32-token
     window outside it); (a) 5 steps at batch 8, seq 128 and (b) one step
     at batch 1, seq 4096, with exactly 2 L forward-with-lse, L dq and L
     dk/dv launches per step; a forward-only loss after (b) on the
     forward without lse (L launches) against plain attention; the
     step's breakdown under ``torch.profiler`` at (a) and at (b);
  11b. the training launcher through the five verbs at
     ``examples/train_lm.py``'s reduced config (d 320, 6 layers, vocab
     2048, batch 8, seq 128, 200 steps) with ``--pallas-attention`` and a
     preemption at step 100: the loss falls, the run resumes from step
     100, and its final parameters are bit-equal to an uninterrupted run;
  12. each flash kernel's registers, spills and static shared memory
     (the ptxas log), the dynamic shared memory its launch asks for, and
     its SASS HMMA (tensor-core) and LDGSTS (cp.async) counts
     (``cuobjdump -sass``): a bf16 kernel without both, an fp32 one with
     HMMA, or a bf16 spill at D 64 fails the phase.  Then device time per
     call (CUDA events behind a queued sleep, the profiler's device sum
     beside it) of the three flash kernels at granite-3-2b's training
     shapes (bf16, causal), their plain versions and SDPA (forward, and
     its backward alone), beside the bound.

  13. the RWKV-6 wkv kernel against its plain version (the exact scan),
     r, k, v fp32 and bf16: the JAX test's four shapes; layer 0's r, k,
     v, w of full-width rwkv6-1.6b at B 1 x S 32768 with a drawn bonus u
     (the model's is zero); w drawn in [0.999, 0.9999], so the state
     carries across thousands of tokens.  Each row (one token's output of
     one head) within ``WKV_TOL`` relative, below what known-wrong kernels
     give (the bonus dropped; the state reset at the middle chunk
     boundary; the decay skipped on one late token; k v^T transposed; the
     last column block of each head taking the next head's u; the dot
     taken on the state after the update);
  14. rwkv6-1.6b at full width (24 layers, d 2048, 32 heads of 64, d_ff
     7168, vocab 65536, bf16, seed 0, ``use_pallas_wkv``):
     ``make_prefill_step`` at B 1 x S 32768 (``PREFILL_32K``'s length, its
     batch cut from 32 to 1) with exactly 24 wkv launches a call, and its
     breakdown under ``torch.profiler``; at S 2048 the model on the kernel
     against the plain path (last and worst hidden row) within
     ``TF_RATIO`` times the plain bf16 path's distance from fp32;
     teacher-forced ``decode_step`` logits against the kernel forward;
     the decode state's bytes equal after a 64- and a 2048-token prompt;
     4 greedy streams (prompt 512, generate 32) through
     ``launch/serve.main --engine batch``; peak device memory;
  15. each wkv instantiation's registers and spills, then device time per
     call of the wkv kernel (CUDA events behind a queued sleep) at B 1 x S
     32768 and B 8 x S 2048 (H 32, D 64, the model's types), its plain
     version once at each, beside the bound; no PyTorch call computes the
     recurrence, so no library time.

  16. hymba-1.5b (32 layers, d 1600, 25 heads over 5 of 64, a parallel
     SSM with state 16, window 1024 on all but 3 layers), whisper-small
     (12 + 12 layers, d 768, 1500 encoder frames, learned positions) and
     paligemma-3b (18 layers, d 2048, MQA of 256, a 256-token image
     prefix) at full width, bf16, random weights from seed 0 (self
     attention's, the SSM's and the MLP's output projections scaled as in
     phase 5): 4 x (32 + 32) through ``launch/serve --engine batch``
     (``run``), the streams varied; hymba also through ``--engine
     legacy`` 4 x (16 + 16), held to ``generate`` under ``SPEC_TIE``;
     teacher-forced on the served tokens, the serving path
     (``prefill_cached`` + ``decode_step``) within ``TF_RATIO`` times the
     bf16 forward's distance from the fp32 forward; then in fp32 hymba's
     legacy engine held to ``generate`` under ``FP32_TIE`` and each
     model's serving path within ``FP32_TF`` of its forward;
  17. each of the three at full width on the flash path where the JAX
     package takes its kernel (hymba, whisper's encoder and decoder; not
     under paligemma's prefix), fp32 masters, remat full: one
     ``loss_and_grads`` with 2 L forward-with-lse, L dq and L dk/dv
     launches and its loss within ``LOSS_RTOL`` of plain attention's; in
     fp32 compute the flash grads within ``FAMILY_GRAD_TOL`` of plain
     attention's, below a 32-token window; a timed ``make_train_step``
     step (hymba 1 x 2048, whisper 4 x 448 over 1500 frames, paligemma 1
     x (256 + 256)) with those launches, its device busy under
     ``torch.profiler`` and the peak memory;
  18. the GA's legacy operator mix (``GAConfig(rgenoud_operators=
     False)``) at the paper's scale on phase 8's problem: the best
     fitness never rising and ending below the initial population's, the
     best w scored by the plain version, 351 fitness launches,
     generations/s and a generation's breakdown.

Phases run in the order 1-5e, 16, 6, 6b, 10-11b, 17, 12, 7, 8, 18, 9,
13-15, so the training state is freed before the CATopt phases.

The last two lines are the kernel report (JSON) and
``{"ok": true, "device": {...}}``.  Without a GPU, or without the
repository around it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
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
# phase 5b, speculation and swap at full width: a stream may leave the
# non-speculative reference only at a near-tie, a token whose top-2 logit
# margin there (the paged step, one token a step) is under SPEC_TIE.  A
# token computed in a chain of W rows, or beside other rows, runs other
# cuBLAS tiles and rounds otherwise: phase 5 prints such rounding between
# two sound bf16 paths on these scaled weights, max|paged - generate|
# teacher-forced, at 4.5625 logits on an H100 80GB HBM3 at 700 W, so a
# margin under twice that can flip.
SPEC_TIE = 9.125
# phases 5d and 5e, the same weights in fp32 (``held_in_fp32``): the paged
# step's teacher-forced logits within FP32_TF of the largest fp32 forward
# logit, and streams that leave fp32 generate's only at a top-2 gap under
# FP32_TIE.  The two paths sum in other orders and shapes, about 1e-6
# relative in fp32; the margins leave room for a deep stack's growth.
FP32_TF = 1e-3
FP32_TIE = 1e-3
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and op/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
KERNEL_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
KERNEL_REPLACES = "src/repro/kernels/paged_attention/kernel.py:332"
INT8_REPLACES = "src/repro/kernels/paged_attention/kernel.py:158"
READONLY_REPLACES = "src/repro/kernels/paged_attention/kernel.py:315"
COPY_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/copy_page.cu"
COPY_REPLACES = "src/repro/kernels/paged_attention/kernel.py:278"
FIT_SOURCE = "src/repro_torch/kernels/recovery/csrc/fitness.cu"
FIT_REPLACES = "src/repro/kernels/recovery/kernel.py:52"
# phase 7, max |kernel - plain| / |plain| of sq: fp32 sums taken in another
# order (an fp64 reference puts the plain version within 4e-7 on
# test_recovery_vs_ref's inputs).  Phase 7 prints what a known-wrong
# reading gives beside it.
FIT_RTOL = 1e-5
GRAD_RTOL = 1e-4         # phase 7: max |grad diff| / max |grad|
PAPER = dict(E=8192, m=2048, P=200)   # catopt.make_problem, GAConfig()
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
FLASH_REPLACES = {"fwd": "src/repro/kernels/flash_attention/kernel.py:394",
                  "fwd_lse": "src/repro/kernels/flash_attention/kernel.py:266",
                  "bwd": "src/repro/kernels/flash_attention/kernel.py:316"}
# phase 10, the worst row's ||kernel - plain|| / ||plain|| (``row_err``).
# fp32: summation order.  bf16: outputs rounded to bf16 (ulp 2^-8
# relative); the forward rounds p at another running max than the plain
# version, the plain backward rounds per-head dk/dv to bf16 before the
# group sum, the kernel once after it.  lse, max |kernel - plain| / max
# |plain|, is fp32 on both sides.  Phase 10 prints what known-wrong
# kernels give beside it.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ROW_ERR = "worst row's ||kernel - plain|| / ||plain||"
LSE_TOL = 1e-5
# phase 11, granite-3-2b in bf16: the flash path's loss against plain
# attention's, relative (bf16 keeps about 3 significant digits); its
# grads, worst leaf's ||flash - plain|| / ||plain||, within GRAD_RATIO
# times the plain bf16 grads' own distance from fp32 grads
LOSS_RTOL = 1e-2
GRAD_RATIO = 2.0
BLAS_KERNELS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")
SLEEP_CYCLES = 100_000_000    # phase 12: about 50 ms of a queued sleep
WKV_SOURCE = "src/repro_torch/kernels/wkv6/csrc/wkv6.cu"
WKV_REPLACES = "src/repro/kernels/wkv6/kernel.py:54"
# phase 13, the worst row's ||kernel - plain|| / ||plain|| (a row: one
# token's output of one head).  fp32: sums over D in another order.  bf16:
# the kernel rounds its output to bf16, up to 2^-8 of each value, against
# the plain version's fp32 output from the same inputs.  Phase 13 prints
# what known-wrong kernels give beside it.
WKV_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
RWKV_SEQ = 32768         # phases 13 to 15: PREFILL_32K's length, batch 1
RWKV_STEPS = 3           # phase 14: timed prefill calls after a warm one


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
        # the split walk: four 4-row pages a split, 11 to 16 pages a request
        ("gemma-2b decode B=4, block 4 (more pages than splits)", dict(
            B=4, S=1, starts=[40, 47, 33, 63], ns=[1, 1, 1, 1], H=8, Hkv=1,
            D=256, BS=4, dtype=bf16), {}),
        # request 0's rows at 32..35 land on page 2, past the walk's 2
        # pages: written by the last split, read by none
        ("granite-3-2b GQA prefill, a fresh page past max_live_blocks",
         dict(B=2, S=16, starts=[20, 2], ns=[16, 1], **granite),
         dict(live=2)),
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
# phase 3b: the rest of the family against its plain versions
# ---------------------------------------------------------------------------

def quantized(torch, c):
    """The case's random pools as the engine fills int8 pages: rows
    quantized by ``ref.quantize_rows`` (int8 pools, fp32 scale pools)."""
    from repro_torch.kernels.paged_attention import ref
    kq, ks = ref.quantize_rows(c["kp"])
    vq, vs = ref.quantize_rows(c["vp"])
    return dict(c, kq=kq, vq=vq, ks=ks, vs=vs)


def call_int8(fn, c):
    return fn(c["q"], c["kn"], c["vn"], c["kq"].clone(), c["vq"].clone(),
              c["tables"], c["pos"], window=c["window"], softcap=c["softcap"],
              max_live_blocks=c["live"], k_scale=c["ks"].clone(),
              v_scale=c["vs"].clone())


def readonly(fn, c, quant, live=None):
    kw = dict(k_scale=c["ks"], v_scale=c["vs"]) if quant else {}
    return fn(c["q"], c["kq"] if quant else c["kp"],
              c["vq"] if quant else c["vp"], c["tables"], c["pos"],
              window=c["window"], softcap=c["softcap"],
              max_live_blocks=c["live"] if live is None else live, **kw)


def judge(name, err, tol, wrong, extra="", what="max|kernel - plain|"):
    """Log one comparison; raise unless ``err`` is within ``tol`` and every
    known-wrong reading lies above it."""
    log(f"[kernel] {name}: {what} = {err:.3e} (tol {tol:g}; "
        f"a wrong kernel: " + ", ".join(f"{k} {v:.3e}"
                                        for k, v in wrong.items())
        + f"){extra}")
    if not err <= tol:
        raise AssertionError(f"kernel disagrees with plain: {name}")
    if min(wrong.values()) <= tol:
        raise AssertionError(f"tolerance {tol} cannot tell a wrong kernel "
                             f"from a right one: {name}")


def chain_unmasked(torch, c):
    """Query positions under which every row of a request's chain sees the
    whole chain: each live row takes its request's last position (what a
    walk without the causal mask inside a verify chain would read)."""
    last = c["pos"].max(dim=1, keepdim=True).values.expand_as(c["pos"])
    return torch.where(c["pos"] >= 0, last, c["pos"])


def verify_chain_cases(torch, dev, worst):
    """The fused update, fp and int8 pools, at the verify-chain shapes of
    speculative decoding: the two-dispatch tick's S = W rows a request (W
    = 2, 4, 5 for draft_k 4: the last token and its draft) and the unified
    tick's row_map view of 5-row chains (S = 8, padded), at gemma-2b's
    width, chains ragged and crossing pages.  Live rows within the
    tolerance, pools (and scale pools) bit-equal; the scatter skipped and
    the chain without its causal mask must read above it."""
    from repro_torch.kernels.paged_attention import kernel, ref
    gemma = dict(H=8, Hkv=1, D=256, BS=16, dtype=torch.bfloat16)
    cases = [(f"S={S} B=4", dict(B=4, S=S, starts=[40, 15, 62, 7],
                                 ns=[S, max(1, S - 1), S, 1], **gemma))
             for S in (2, 4, 5)]
    cases.append(("S=8 (the unified tick's view of 5-row chains) B=4",
                  dict(B=4, S=8, starts=[40, 13, 62, 0], ns=[5, 3, 1, 0],
                       **gemma)))
    for i, (name, shape) in enumerate(cases):
        c = quantized(torch, make_case(torch, dev, 700 + i, **shape))
        live = c["pos"] >= 0
        for quant in (False, True):
            fn = call_int8 if quant else call
            want = fn(ref.unified_attention_update, c)
            got = fn(kernel.paged_attention_update, c)
            torch.cuda.synchronize()

            def max_err(out):
                return (out.float() - want[0].float())[live].abs().max() \
                    .item()

            scales = (dict(k_scale=want[3], v_scale=want[4]) if quant
                      else {})
            wrong = {"scatter skipped": max_err(readonly(
                         ref.paged_attention, c, quant)),
                     "no causal mask in the chain": max_err(
                         ref.paged_attention(
                             c["q"], want[1], want[2], c["tables"],
                             chain_unmasked(torch, c), window=c["window"],
                             softcap=c["softcap"], max_live_blocks=c["live"],
                             **scales))}
            equal = all(torch.equal(got[j][1:], want[j][1:])
                        for j in range(1, len(want)))
            finite = bool(torch.isfinite(got[0].float()).all())
            kind = "int8" if quant else "fp"
            judge(f"verify chain, {kind} pools, gemma-2b {name}",
                  max_err(got[0]), TOL["bfloat16"], wrong,
                  f", pools bit-equal {equal}, finite {finite}")
            if not (equal and finite):
                raise AssertionError(f"verify chain: pools differ or "
                                     f"non-finite output: {kind} {name}")
            key = "int8" if quant else "verify"
            worst[key] = max(worst[key], max_err(got[0]))


def d128_cases(torch, dev, worst):
    """The walk at head_dim 128, split over pages, bf16, block 16: the
    fused update over fp and int8 pools and the read-only walk over both,
    at glm4-9b's decode (B 4, S 1, 32 heads over 2 kv heads), olmoe-1b-7b's
    prefill chunk crossing pages (S 16, 16 heads, 16 kv heads) and
    grok-1-314b's GQA (48 heads over 8) with softcap 30.  Live rows within
    the tolerance, below a walk that skips the scatter, drops the last
    page or (int8) skips the scales; the update's pools and scale pools
    bit-equal, the read-only walk's unchanged.  With int8 pools the
    outputs are held to the plain version in the TPU kernel's precision
    (``repro/kernels/paged_attention/kernel.py:114-139`` dequantizes into
    fp32 and keeps p in fp32, as this kernel does): the plain version on
    fp32 q and fresh rows.  On bf16 q it rounds the dequantized pages and
    p to bf16, and lands 2 bf16 ulps (0.03125 on an H100) from the kernel
    at grok-1-314b's shape in ``tests/test_torch_cuda.py``, further from
    the fp32 result than the kernel is."""
    from repro_torch.kernels.paged_attention import kernel, ref
    bf16 = torch.bfloat16
    cases = [
        ("glm4-9b decode S=1 B=4, H 32 Hkv 2", dict(
            B=4, S=1, starts=[40, 47, 33, 63], ns=[1, 1, 1, 1], H=32, Hkv=2,
            D=128, BS=16, dtype=bf16), {}),
        ("olmoe-1b-7b prefill chunk S=16 B=3 crossing pages, H 16 Hkv 16",
         dict(B=3, S=16, starts=[8, 20, 0], ns=[16, 16, 11], H=16, Hkv=16,
              D=128, BS=16, dtype=bf16), {}),
        ("grok-1-314b GQA S=2 B=3, H 48 Hkv 8, softcap 30", dict(
            B=3, S=2, starts=[30, 55, 4], ns=[2, 1, 2], H=48, Hkv=8, D=128,
            BS=16, dtype=bf16), dict(softcap=30.0)),
    ]
    tol = TOL["bfloat16"]
    for i, (name, shape, extra) in enumerate(cases):
        c = quantized(torch, dict(make_case(torch, dev, 800 + i, **shape),
                                  **extra))
        live = c["pos"] >= 0
        for quant in (False, True):
            kind = "int8" if quant else "fp"
            fn = call_int8 if quant else call
            want = fn(ref.unified_attention_update, c)
            got = fn(kernel.paged_attention_update, c)
            # the plain version in the TPU kernel's precision
            cp = (dict(c, **{k: c[k].float() for k in ("q", "kn", "vn")})
                  if quant else c)
            out_want = fn(ref.unified_attention_update, cp)[0]
            pools = ([c["kq"], c["vq"], c["ks"], c["vs"]] if quant
                     else [c["kp"], c["vp"]])
            before = [x.clone() for x in pools]
            ro = readonly(kernel.paged_attention, c, quant)
            ro_want = readonly(ref.paged_attention, cp, quant).float()
            torch.cuda.synchronize()

            def err(out, to):
                return (out.float() - to.float())[live].abs().max().item()

            wrong = {"scatter skipped": err(ro_want, out_want),
                     "last page dropped": err(fn(
                         ref.unified_attention_update,
                         dict(cp, live=c["live"] - 1))[0], out_want)}
            ro_wrong = {"last page dropped": err(readonly(
                ref.paged_attention, cp, quant, live=c["live"] - 1), ro_want)}
            if quant:
                ones = torch.ones_like(c["ks"])
                no_scales = ref.paged_attention(
                    cp["q"], c["kq"], c["vq"], c["tables"], c["pos"],
                    window=c["window"], softcap=c["softcap"],
                    max_live_blocks=c["live"], k_scale=ones, v_scale=ones)
                ro_wrong["scales skipped"] = err(no_scales, ro_want)
            equal = all(torch.equal(got[j][1:], want[j][1:])
                        for j in range(1, len(want)))
            finite = bool(torch.isfinite(got[0].float()).all()
                          and torch.isfinite(ro.float()).all())
            judge(f"D 128 {kind} update, {name}", err(got[0], out_want), tol,
                  wrong, f", pools bit-equal {equal}, finite {finite}")
            unchanged = all(torch.equal(x, y) for x, y in zip(pools, before))
            judge(f"D 128 {kind} read-only, {name}", err(ro, ro_want), tol,
                  ro_wrong, f", pools unchanged {unchanged}")
            if not (equal and finite and unchanged):
                raise AssertionError(f"D 128 walk: pools differ, a pool "
                                     f"written or non-finite: {kind} {name}")
            worst["d128"] = max(worst["d128"], err(got[0], out_want),
                                err(ro, ro_want))


def gemma_cache_sets(torch, dev, L, NB, seed):
    """gemma-2b's cache at batch 4 (block 16, one kv head of 256), as the
    engine holds it: {"fp": [K, V] bf16, "int8": [K, V, K-scale,
    V-scale]}, random rows (int8: quantized by ``ref.quantize_rows``)."""
    from repro_torch.kernels.paged_attention import ref
    g = torch.Generator(device=dev).manual_seed(seed)
    k, v = (torch.randn((L, NB, 16, 1, 256), generator=g, device=dev)
            for _ in range(2))
    (kq, ks), (vq, vs) = ref.quantize_rows(k), ref.quantize_rows(v)
    return {"fp": [k.to(torch.bfloat16), v.to(torch.bfloat16)],
            "int8": [kq, vq, ks.contiguous(), vs.contiguous()]}


def copy_pages_cases(torch, dev, worst):
    """copy_pages over gemma-2b's whole cache at batch 4, fp and int8
    pages, host and device ids: one launch a call, page dst bit-equal to
    page src in every layer of every pool, every other page untouched,
    beside a copy that stops at layer 0 and one that skips the last pool;
    bad device ids copy nothing in any pool and set the error flag once a
    call."""
    from repro_torch.kernels.paged_attention import kernel
    L, NB = 18, 17
    sets = gemma_cache_sets(torch, dev, L, NB, 401)
    for name, pools in sets.items():
        for src, dst in ((3, 7), (12, 2)):
            before = [p.clone() for p in pools]
            device_ids = src == 12
            ids = ((torch.tensor([src, dst], dtype=torch.int32,
                                 device=dev),) if device_ids else (src, dst))
            n0 = kernel.copy_launches
            kernel.copy_pages(pools, *ids)
            torch.cuda.synchronize()
            n = kernel.copy_launches - n0
            keep = [p for p in range(NB) if p != dst]

            def mismatch(ps):
                return max((p[:, dst].float() - b[:, src].float())
                           .abs().max().item() for p, b in zip(ps, before))

            stops = [b.clone() for b in before]
            for x, b in zip(stops, before):
                x[0, dst] = b[0, src]
            skips = [b.clone() for b in before]
            for x, b in zip(skips[:-1], before):
                x[:, dst] = b[:, src]
            untouched = all(torch.equal(p[:, keep], b[:, keep])
                            for p, b in zip(pools, before))
            judge(f"copy_pages {name} cache ({len(pools)} pools) {src} -> "
                  f"{dst} ({'device' if device_ids else 'host'} ids)",
                  mismatch(pools), 0.0,
                  {"stops at layer 0": mismatch(stops),
                   "last pool skipped": mismatch(skips)},
                  f", other pages untouched {untouched}, {n} launch")
            if not (untouched and n == 1):
                raise AssertionError(f"copy_pages moved another page or "
                                     f"took {n} launches: {name}")
            worst["copy"] = max(worst["copy"], mismatch(pools))
    for name, pools in sets.items():
        before = [p.clone() for p in pools]
        for bad in ([4, 4], [0, NB], [-1, 3]):
            kernel.copy_pages(pools, torch.tensor(bad, dtype=torch.int32,
                                                  device=dev))
            if kernel.copy_page_errors(dev) != 1:
                raise AssertionError(f"copy_pages took bad device ids {bad}")
        if not all(torch.equal(p, b) for p, b in zip(pools, before)):
            raise AssertionError("copy_pages wrote with bad device ids")
        log(f"[kernel] copy_pages {name} cache: bad device ids [4, 4], "
            f"[0, {NB}], [-1, 3] set the error flag once each and copy "
            f"nothing in any pool")


def phase_family_vs_plain(torch, dev):
    """The int8 update, the read-only walk (fp and int8), the walk at
    head_dim 128 and copy_page / copy_pages against their plain versions
    at the main paths' shapes, and the fused update at the verify-chain
    shapes.  Returns the worst max |kernel - plain| of each: {"int8",
    "readonly", "copy", "verify", "d128"} ("verify": the fp update at the
    chain shapes; int8 chains count under "int8")."""
    from repro_torch.kernels.paged_attention import kernel, ref
    build_report("paged_attention")
    build_report("copy_page")
    bf16, f32 = torch.bfloat16, torch.float32
    gemma = dict(H=8, Hkv=1, D=256, BS=16, dtype=bf16)
    granite = dict(H=32, Hkv=8, D=64, BS=16, dtype=bf16)
    worst = {"int8": 0.0, "readonly": 0.0, "copy": 0.0, "verify": 0.0,
             "d128": 0.0}
    # -- the fused update over int8 pools: pools bit-equal ----------------
    cases = [
        ("int8 gemma-2b decode S=1 B=4", dict(
            B=4, S=1, starts=[40, 47, 33, 63], ns=[1, 1, 1, 1], **gemma), {}),
        ("int8 gemma-2b decode bucket S=1 B=8, 4 padded", dict(
            B=8, S=1, starts=[40, 0, 47, 0, 33, 0, 63, 0],
            ns=[1, 0, 1, 0, 1, 0, 1, 0], **gemma), {}),
        ("int8 gemma-2b prefill bucket S=16 B=4", dict(
            B=4, S=16, starts=[8, 20, 0, 40], ns=[16, 16, 11, 16], **gemma),
         {}),
        ("int8 granite-3-2b GQA prefill S=16 D=64", dict(
            B=3, S=16, starts=[0, 9, 50], ns=[16, 7, 16], **granite), {}),
        ("int8 gemma-2b window 24 + softcap 50", dict(
            B=4, S=16, starts=[30, 0, 60, 17], ns=[16, 16, 5, 1], **gemma),
         dict(window=24, softcap=50.0)),
        ("int8 reduced fp32 D=16 G=2", dict(
            B=3, S=5, starts=[3, 0, 9], ns=[5, 2, 1], H=4, Hkv=2, D=16, BS=4,
            dtype=f32), dict(window=6)),
        ("int8 gemma-2b decode B=4, block 4 (more pages than splits)", dict(
            B=4, S=1, starts=[40, 47, 33, 63], ns=[1, 1, 1, 1], H=8, Hkv=1,
            D=256, BS=4, dtype=bf16), {}),
        ("int8 granite-3-2b GQA prefill, a fresh page past max_live_blocks",
         dict(B=2, S=16, starts=[20, 2], ns=[16, 1], **granite),
         dict(live=2)),
    ]
    for i, (name, shape, extra) in enumerate(cases):
        c = quantized(torch, dict(make_case(torch, dev, 200 + i, **shape),
                                  **extra))
        want = call_int8(ref.unified_attention_update, c)
        got = call_int8(kernel.paged_attention_update, c)
        torch.cuda.synchronize()
        live = c["pos"] >= 0

        def max_err(out):
            return (out.float() - want[0].float())[live].abs().max().item()

        ones = torch.ones_like(c["ks"])
        wrong = {"scales skipped": max_err(ref.paged_attention(
                     c["q"], want[1], want[2], c["tables"], c["pos"],
                     window=c["window"], softcap=c["softcap"],
                     max_live_blocks=c["live"], k_scale=ones, v_scale=ones)),
                 "scatter skipped": max_err(readonly(ref.paged_attention, c,
                                                     True))}
        tol = TOL[str(shape["dtype"]).split(".")[-1]]
        pools_equal = all(torch.equal(got[j], want[j]) for j in range(1, 5))
        finite = bool(torch.isfinite(got[0].float()).all())
        judge(name, max_err(got[0]), tol, wrong,
              f", pools and scale pools bit-equal {pools_equal}, finite "
              f"{finite}")
        if not (pools_equal and finite):
            raise AssertionError(f"int8 update: pools differ or non-finite "
                                 f"output: {name}")
        worst["int8"] = max(worst["int8"], max_err(got[0]))
    verify_chain_cases(torch, dev, worst)
    d128_cases(torch, dev, worst)
    # -- the read-only walk, fp and int8: pools unchanged -----------------
    cases = [
        ("gemma-2b decode S=1 B=4", dict(
            B=4, S=1, starts=[40, 47, 33, 63], ns=[1, 1, 1, 1], **gemma), {}),
        ("gemma-2b chunk S=16 B=4", dict(
            B=4, S=16, starts=[8, 20, 0, 40], ns=[16, 16, 11, 16], **gemma),
         {}),
        ("granite-3-2b GQA decode D=64", dict(
            B=4, S=1, starts=[5, 70, 31, 0], ns=[1, 1, 1, 0], **granite), {}),
        ("gemma-2b window 24 + softcap 50", dict(
            B=4, S=16, starts=[30, 0, 60, 17], ns=[16, 16, 5, 1], **gemma),
         dict(window=24, softcap=50.0)),
        ("reduced fp32 D=16 G=2", dict(
            B=3, S=5, starts=[3, 0, 9], ns=[5, 2, 1], H=4, Hkv=2, D=16, BS=4,
            dtype=f32), dict(window=6)),
        ("gemma-2b decode B=4, block 4 (more pages than splits)", dict(
            B=4, S=1, starts=[40, 47, 33, 63], ns=[1, 1, 1, 1], H=8, Hkv=1,
            D=256, BS=4, dtype=bf16), {}),
    ]
    for i, (name, shape, extra) in enumerate(cases):
        c = quantized(torch, dict(make_case(torch, dev, 300 + i, **shape),
                                  **extra))
        live = c["pos"] >= 0
        for quant in (False, True):
            pools = ([c["kq"], c["vq"], c["ks"], c["vs"]] if quant
                     else [c["kp"], c["vp"]])
            before = [x.clone() for x in pools]
            want = readonly(ref.paged_attention, c, quant).float()
            got = readonly(kernel.paged_attention, c, quant)
            torch.cuda.synchronize()

            def max_err(out):
                return (out.float() - want)[live].abs().max().item()

            wrong = {}
            if c["live"] > 1:
                wrong["last page dropped"] = max_err(readonly(
                    ref.paged_attention, c, quant, live=c["live"] - 1))
            if quant:
                ones = torch.ones_like(c["ks"])
                wrong["scales skipped"] = max_err(ref.paged_attention(
                    c["q"], c["kq"], c["vq"], c["tables"], c["pos"],
                    window=c["window"], softcap=c["softcap"],
                    max_live_blocks=c["live"], k_scale=ones, v_scale=ones))
            unchanged = all(torch.equal(x, y) for x, y in zip(pools, before))
            tol = TOL[str(shape["dtype"]).split(".")[-1]]
            judge(f"read-only {'int8' if quant else 'fp'} {name}",
                  max_err(got), tol, wrong,
                  f", pools unchanged {unchanged}")
            if not unchanged:
                raise AssertionError(f"read-only walk wrote a pool: {name}")
            worst["readonly"] = max(worst["readonly"], max_err(got))
    # -- copy_page: dst == src in every layer, nothing else moves ---------
    g = torch.Generator(device=dev).manual_seed(400)
    L, NB = 18, 17                      # gemma-2b's pools at batch 4
    k_pool = torch.randn((L, NB, 16, 1, 256), generator=g,
                         device=dev).to(bf16)
    pools = {"bf16 K pool (18, 17, 16, 1, 256)": k_pool,
             "int8 K pool (18, 17, 16, 1, 256)": ref.quantize_rows(k_pool)[0],
             "fp32 scale pool (18, 17, 16, 1)":
                 ref.quantize_rows(k_pool)[1].contiguous()}
    for name, pool in pools.items():
        for src, dst in ((3, 7), (12, 2)):
            before = pool.clone()
            device_ids = src == 12
            if device_ids:
                kernel.copy_page(pool, torch.tensor([src, dst],
                                                    dtype=torch.int32,
                                                    device=dev))
            else:
                kernel.copy_page(pool, src, dst)
            torch.cuda.synchronize()
            keep = [p for p in range(NB) if p != dst]

            def mismatch(p):
                return (p[:, dst].float() - before[:, src].float()).abs() \
                    .max().item()

            stops = before.clone()
            stops[0, dst] = before[0, src]
            wrong = {"stops at layer 0": mismatch(stops)}
            untouched = torch.equal(pool[:, keep], before[:, keep])
            judge(f"copy_page {name} {src} -> {dst} "
                  f"({'device' if device_ids else 'host'} ids)",
                  mismatch(pool), 0.0, wrong,
                  f", other pages untouched {untouched}")
            if not untouched:
                raise AssertionError(f"copy_page moved another page: {name}")
            worst["copy"] = max(worst["copy"], mismatch(pool))
    before = k_pool.clone()
    for bad in ([4, 4], [0, NB], [-1, 3]):
        kernel.copy_page(k_pool, torch.tensor(bad, dtype=torch.int32,
                                              device=dev))
        if kernel.copy_page_errors(dev) != 1:
            raise AssertionError(f"copy_page took bad device ids {bad}")
    if not torch.equal(k_pool, before) or kernel.copy_page_errors(dev):
        raise AssertionError("copy_page wrote with bad device ids")
    log("[kernel] copy_page: bad device ids [4, 4], [0, 17], [-1, 3] set "
        "the error flag and copy nothing")
    copy_pages_cases(torch, dev, worst)
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


def paged_logits(torch, dev, cfg, params, seq, P, BS, kv_dtype=None):
    """fp32 logits of the token sequences ``seq`` (B, T) through the paged
    step on the kernel: the prompt in chunks of BS, then one token per
    step, as the engine feeds them (``kv_dtype``: the pools' type)."""
    from repro_torch.serving.paged_attn import init_paged_cache, paged_step
    B, T = seq.shape
    MB = -(-T // BS)
    cache = init_paged_cache(cfg, 1 + B * MB, BS, device=dev,
                             kv_dtype=kv_dtype)
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
    return torch.cat(paged, dim=1)[..., :cfg.vocab]


def forward_f32(torch, cfg, params, seq):
    """fp32 logits of ``seq`` (B, T): ``M.forward`` in fp32 with each
    layer's weights cast to fp32 only while it runs, so the fp32 copy
    never holds more than one layer (grok-1-314b's takes 19.3 GB)."""
    import dataclasses
    from repro_torch.models.layers import (apply_norm, embed_tokens,
                                           logits_from_hidden)
    from repro_torch.models.transformer import (layer_body, layer_windows,
                                                unstack)
    c32 = dataclasses.replace(cfg, dtype="float32")
    with torch.no_grad():
        x = embed_tokens(params["embed"], seq, c32)
        pos = torch.arange(seq.shape[1], device=seq.device)
        windows = layer_windows(cfg)
        for i, lp in enumerate(unstack(params["layers"], cfg.n_layers)):
            x = layer_body(tree_map(lambda t: t.float(), lp), x, c32,
                           positions=pos, window=int(windows[i]))
        head = {k: tree_map(lambda t: t.float(), params[k])
                for k in ("embed", "lm_head") if k in params}
        return logits_from_hidden(head, apply_norm(params["final_ln"], x),
                                  c32)[..., :cfg.vocab]


def teacher_forced(torch, dev, cfg, params, seq, P, BS):
    """Logits of the token sequences ``seq`` (B, T) three ways: through
    the paged step on the kernel (:func:`paged_logits`), through the dense
    bf16 ``forward`` the oracle uses, and through ``forward`` in fp32
    (:func:`forward_f32`).  Returns max |paged - bf16|, max |paged -
    fp32|, max |bf16 - fp32|."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import logits_from_hidden
    paged = paged_logits(torch, dev, cfg, params, seq, P, BS)
    with torch.no_grad():
        bf16 = logits_from_hidden(params, M.forward(
            cfg, params, {"tokens": seq}), cfg).float()[..., :cfg.vocab]
    f32 = forward_f32(torch, cfg, params, seq)
    return ((paged - bf16).abs().max().item(),
            (paged - f32).abs().max().item(),
            (bf16 - f32).abs().max().item())


def tick_breakdown(torch, cfg, params, prompts, G, kw, ticks=8, label=""):
    """Wall and device busy time per decode tick (4 requests decoding,
    after at least 4 ticks and the whole prefill), the launches on the
    card per tick, that busy time split into the paged walk, the expert
    products (``aten::bmm``, the MoE block's only batched product) and
    the rest, and the kernels that take the most device time.  Returns
    the numbers in ms."""
    from repro_torch.serving import PagedServingEngine
    eng = PagedServingEngine(cfg, params, **kw)
    for row in prompts:
        eng.submit(row, G)
    n = 0
    while n < 4 or any(ph != "decode" for ph in eng.slot_phase):
        eng.step()
        n += 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / ticks * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
    rows = device_kernels(torch, prof)
    busy = sum(r[0] for r in rows) / ticks / 1e3
    launches = sum(r[1] for r in rows) / ticks
    walk = sum(r[0] for r in rows if "paged_kernel" in r[2]) / ticks / 1e3
    bmm, n_bmm = 0.0, 0
    for e in prof.key_averages():
        if e.key == "aten::bmm":
            us = getattr(e, "device_time_total", None)
            bmm = (us if us is not None else e.cuda_time_total) / ticks / 1e3
            n_bmm = e.count // ticks
    log(f"[tick] {cfg.name}{label} decode B={len(prompts)}: wall "
        f"{wall:.3f} ms/tick, device busy {busy:.3f} ms/tick, idle share "
        f"{1 - busy / wall:.3f}, {launches:g} launches on the card a tick; "
        f"the walk {walk:.4f} ms, the expert products {bmm:.4f} ms in "
        f"{n_bmm} calls, the rest {busy - walk - bmm:.4f} ms")
    for us, k, key in rows[:12]:
        log(f"[tick]   {us / ticks / 1e3:.4f} ms x{k // ticks}  {key[:90]}")
    return dict(wall_ms=wall, busy_ms=busy, launches=launches, walk_ms=walk,
                bmm_ms=bmm, bmm_calls=n_bmm, rest_ms=busy - walk - bmm)


def gemma_serving(torch, dev):
    """gemma-2b at full width with random weights from seed 0, the output
    projections scaled (below), 4 prompts of 32 tokens and the engine's
    arguments for 32 generated tokens in pages of 16: phase 5's setup."""
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.models import model as M
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
    return cfg, params, prompts, kw


def held_to_generate(tag, streams, toks, top2, allowed):
    """Hold served ``streams`` to ``generate``'s tokens ``toks``: a stream
    may leave them only where the oracle's top two logits (``top2``) are
    within ``allowed`` of each other, where rounding alone can swap them.
    Returns how many streams are identical."""
    exact = 0
    for b, (got, ref) in enumerate(zip(streams, toks)):
        G = len(ref)
        if len(got) != G:
            raise AssertionError(f"{tag} request {b} served {len(got)} "
                                 f"tokens, generate {G}")
        t = next((i for i in range(G) if got[i] != ref[i]), None)
        if t is None:
            exact += 1
            log(f"{tag} request {b}: {G} tokens identical to generate")
            continue
        gap = (top2[b, t, 0] - top2[b, t, 1]).item()
        log(f"{tag} request {b}: first divergence at token {t}: oracle "
            f"top-2 gap {gap:.4f} (allowed < {allowed:.4f})")
        if not gap < allowed:
            raise AssertionError(f"{tag} request {b} diverges at token {t} "
                                 f"with a clear top-2 gap {gap}")
    log(f"{tag} {exact}/{len(toks)} streams identical to generate")
    return exact


def phase_full_width(torch, dev):
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.launch.serve import generate
    from repro_torch.serving import PagedServingEngine
    cfg, params, prompts, kw = gemma_serving(torch, dev)
    B, P = prompts.shape
    G, BS = 32, kw["block_size"]
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
    held_to_generate("[full]", [results[i] for i in ids], toks, top2,
                     2 * tf_err)
    tick_breakdown(torch, cfg, params, prompts, G, kw)
    tick_breakdown(torch, cfg, params, prompts, G,
                   dict(kw, kv_dtype="int8"), label=" int8 pages")
    return dict(launches=launches, tokens_per_s=n_tok / wall, cfg=cfg,
                params=params, prompts=prompts, tf_err=tf_err)


# ---------------------------------------------------------------------------
# phase 5b: the engine's ported options at full width
# ---------------------------------------------------------------------------

def counts(kernel):
    return dict(fp=kernel.launches, int8=kernel.int8_launches,
                readonly=kernel.readonly_launches, copy=kernel.copy_launches)


def zero_counts(kernel):
    kernel.launches = kernel.int8_launches = 0
    kernel.readonly_launches = kernel.copy_launches = 0


def varied(label, streams):
    """Raise if the streams cannot tell a wrong attention: together they
    must hold more than three distinct tokens (one repeated token per
    stream is what the token embedding alone gives)."""
    distinct = len({t for s in streams for t in s})
    log(f"[full] {label}: distinct tokens per stream "
        f"{[len(set(s)) for s in streams]}, {distinct} in all")
    if distinct <= 3:
        raise AssertionError(f"{label}: the streams barely vary; they "
                             f"cannot tell a wrong attention")


def serve(eng, waves):
    """Serve ``waves`` of (prompt, gen) lists one after the other; returns
    the streams in submission order."""
    out = []
    for wave in waves:
        ids = [eng.submit(p, g) for p, g in wave]
        res = eng.run_to_completion()
        out += [res[i] for i in ids]
    return out


def readonly_over_engine(torch, dev, eng, label, worst):
    """The read-only walk (the public op ``paged_attn.paged_attention``)
    over the pools a full-width engine filled, while its requests decode:
    each request's table, one random query per request at its last
    written position, layers 0 and L-1, against the plain version; the
    pools must not change.  Returns the op's launches."""
    import numpy as np
    from repro_torch.kernels.paged_attention import kernel, ref
    from repro_torch.serving import paged_attn
    cfg, cache = eng.cfg, eng.cache
    slots = [s for s, r in enumerate(eng.slot_req) if r is not None]
    tables = torch.from_numpy(np.stack(
        [eng.tables[s].as_row() for s in slots])).to(dev)
    pos = torch.tensor([[int(eng.slot_filled[s]) - 1] for s in slots],
                       dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(500)
    q = torch.randn((len(slots), 1, cfg.n_heads, cfg.head_dim), generator=g,
                    device=dev).to(getattr(torch, cfg.dtype))
    live = int(pos.max()) // eng.block_size + 1
    quant = "k_scale" in cache
    tol = TOL[cfg.dtype]
    n0 = kernel.readonly_launches
    for layer in (0, cfg.n_layers - 1):
        kw = (dict(k_scale=cache["k_scale"][layer],
                   v_scale=cache["v_scale"][layer]) if quant else {})
        before = [cache[n][layer].clone() for n in cache]
        args = (q, cache["k"][layer], cache["v"][layer], tables, pos)
        got = paged_attn.paged_attention(*args, window=FULL, softcap=0.0,
                                         max_live_blocks=live, **kw)
        want = ref.paged_attention(*args, window=FULL, softcap=0.0,
                                   max_live_blocks=live, **kw).float()
        dropped = ref.paged_attention(*args, window=FULL, softcap=0.0,
                                      max_live_blocks=live - 1, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        unchanged = all(torch.equal(cache[n][layer], b)
                        for n, b in zip(cache, before))
        judge(f"read-only over the full-width {label} pools, layer {layer}, "
              f"{len(slots)} requests at positions {pos[:, 0].tolist()}",
              err, tol, {"last page dropped":
                         (dropped.float() - want).abs().max().item()},
              f", pools unchanged {unchanged}")
        if not unchanged:
            raise AssertionError("the read-only walk wrote the engine's pools")
        worst["readonly"] = max(worst["readonly"], err)
    return kernel.readonly_launches - n0


def phase_full_width_options(torch, dev, full, worst):
    """gemma-2b at full width through the engine's ported options:
    int8 pages, the prefix cache (copy-on-write), the two-dispatch tick,
    and the read-only walk over the filled pools.  Returns the main-path
    launches of the int8 update, the read-only walk and copy_page."""
    import numpy as np
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.serving import PagedServingEngine
    cfg, params = full["cfg"], full["params"]
    prompts = full["prompts"]                   # phase 5's
    (B, P), G, BS = prompts.shape, 16, 16
    rng = np.random.default_rng(2)
    kw = dict(max_slots=B, block_size=BS,
              max_blocks_per_seq=-(-(P + G) // BS), device=dev)
    out = {}

    def drive(eng, label):
        """Submit the batch, run until every request decodes, hold the
        read-only walk against plain over the pools, then finish."""
        ids = [eng.submit(row, G) for row in prompts]
        for _ in range(64):
            if all(p == "decode" for p in eng.slot_phase):
                break
            eng.step()
        for _ in range(3):
            eng.step()
        n_ro = readonly_over_engine(torch, dev, eng, label, worst)
        res = eng.run_to_completion()
        return [res[i] for i in ids], n_ro

    # -- int8 pages ------------------------------------------------------
    eng = PagedServingEngine(cfg, params, kv_dtype="int8", **kw)
    torch.cuda.synchronize()
    zero_counts(kernel)
    t0 = time.perf_counter()
    streams8, n_ro8 = drive(eng, "int8")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts(kernel)
    per_pass = cfg.n_layers * eng.dispatches
    log(f"[full] int8 pages: {B} requests x {G} tokens in {eng.dispatches} "
        f"ticks, {wall:.3f} s (read-only checks included); launches "
        f"{c} (int8 update: n_layers {cfg.n_layers} x dispatches "
        f"{eng.dispatches} = {per_pass}); page bytes "
        f"{eng.alloc.utilization()['page_bytes_per_shard']} against fp "
        f"{eng.alloc.utilization()['fp_page_bytes_per_shard']}")
    if not (c["int8"] == per_pass > 0 and c["fp"] == 0):
        raise AssertionError("int8 pages: the engine did not run the int8 "
                             "update once per layer per tick")
    if [len(s) for s in streams8] != [G] * B:
        raise AssertionError("int8 pages: a request did not finish")
    varied("int8 pages", streams8)
    out["int8"] = c["int8"]
    out["readonly"] = n_ro8
    # -- the unified tick (fp pages) and the two-dispatch tick -----------
    streams = {}
    for unified in (True, False):
        eng = PagedServingEngine(cfg, params, unified=unified, **kw)
        torch.cuda.synchronize()
        zero_counts(kernel)
        streams[unified], n_ro = drive(eng, "fp" if unified else
                                       "fp (two-dispatch tick)")
        c = counts(kernel)
        log(f"[full] {'unified' if unified else 'two-dispatch'} tick: "
            f"{eng.dispatches} passes, launches {c}")
        varied(f"{'unified' if unified else 'two-dispatch'} tick",
               streams[unified])
        if c["fp"] != cfg.n_layers * eng.dispatches:
            raise AssertionError("a tick did not run the fp update once per "
                                 "layer per pass")
        out["readonly"] += n_ro
    same = [a == b for a, b in zip(streams[True], streams[False])]
    log(f"[full] two-dispatch tick streams equal the unified tick's: "
        f"{same}")
    if not all(same):
        raise AssertionError("the two-dispatch tick's streams differ from "
                             "the unified tick's")
    # -- the prefix cache: a 48-token system prompt, distinct 112-token
    # suffixes, and one prompt repeated in full (its last token is
    # recomputed into a copy-on-write page).  With short suffixes every
    # stream of this random model repeats one token (16: one token in
    # all; 48: two), the shared keys outweighing the rest ----------------
    sysp = rng.integers(0, cfg.vocab, 3 * BS, dtype=np.int32)
    shared = [np.concatenate([sysp, rng.integers(0, cfg.vocab, 7 * BS,
                                                 dtype=np.int32)])
              for _ in range(3)]
    waves = [[(p, 8)] for p in shared] + [[(shared[0].copy(), 8)]]
    # Both runs must compute every token in the same shapes, or cuBLAS and
    # the reductions round it another way and a near-tie may flip: one
    # slot, so each request runs alone, and chunks of 3 tokens, so chunk
    # bounds fall on 48 (where a hit's prefill starts) and the cache-off
    # run computes the repeated prompt's last token (159) alone, as the
    # cache-on run recomputes it into the copied page.  A pool that keeps
    # every cached page.
    pkw = dict(kw, max_slots=1, max_blocks_per_seq=-(-(10 * BS + 8) // BS),
               num_blocks=48, prefill_chunk=3)
    runs = {}
    for pc in (False, True):
        eng = PagedServingEngine(cfg, params, prefix_cache=pc, **pkw)
        torch.cuda.synchronize()
        zero_counts(kernel)
        runs[pc] = (serve(eng, waves), counts(kernel),
                    eng.metrics()["prefix_cache"])
    (off, _, _), (on, c, m) = runs[False], runs[True]
    log(f"[full] prefix cache: hits {m['hit_tokens']} of "
        f"{m['lookup_tokens']} prompt tokens, page hits {m['page_hits']}, "
        f"copy-on-write copies {m['cow_copies']} (one copy launch each, "
        f"every pool), launches {c}; streams "
        f"byte-equal to the cache off: {[a == b for a, b in zip(on, off)]}")
    if on != off:
        raise AssertionError("prefix cache: streams differ from the cache "
                             "off")
    varied("prefix cache", on)
    if not (m["hit_tokens"] > 0 and m["cow_copies"] > 0
            and c["copy"] == m["cow_copies"]):
        raise AssertionError("prefix cache: no hit, or not one copy_pages "
                             "launch a copy-on-write")
    out["copy"] = c["copy"]
    return out


def stepwise_margins(torch, dev, cfg, params, seq, P, BS, kv_dtype=None):
    """Top-2 logit margins of :func:`paged_logits` (the non-speculative
    engine's feeding): ``[b, p]`` is the gap between the two largest
    logits that predict token ``p + 1``."""
    top2 = torch.topk(paged_logits(torch, dev, cfg, params, seq, P, BS,
                                   kv_dtype), 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).cpu()


def near_ties(label, got, want, margins, P):
    """Hold streams ``got`` to the reference streams ``want``: equal, or
    leaving them first where the reference's top-2 margin (``margins``,
    from :func:`stepwise_margins` over prompt + ``want``) is under
    ``SPEC_TIE``.  Returns how many streams are identical."""
    exact = 0
    for b, (g, w) in enumerate(zip(got, want)):
        if len(g) != len(w):
            raise AssertionError(f"{label}: request {b} served {len(g)} "
                                 f"tokens, the reference {len(w)}")
        t = next((i for i in range(len(w)) if g[i] != w[i]), None)
        if t is None:
            exact += 1
            continue
        gap = margins[b, P + t - 1].item()
        log(f"[spec] {label}: request {b} first leaves the reference at "
            f"token {t}: its top-2 margin {gap:.4f} (a near-tie under "
            f"{SPEC_TIE:g})")
        if not gap < SPEC_TIE:
            raise AssertionError(f"{label}: request {b} diverges at token "
                                 f"{t} with a clear top-2 margin {gap}")
    log(f"[spec] {label}: {exact}/{len(want)} streams identical to the "
        f"reference")
    return exact


def watch_host_copies(torch, eng):
    """Instrument ``eng``'s host copies (swap out and in, spill, restore):
    each payload must equal the device pages it was taken from, and each
    copy back must leave the pages bit-equal to the payload.  Returns the
    tally {"out", "in": [calls, pages, seconds], "equal": bool}."""
    tally = {"out": [0, 0, 0.0], "in": [0, 0, 0.0], "equal": True}
    to_host, from_host = eng._pages_to_host, eng._pages_from_host

    def pages_to_host(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload = to_host(blocks)
        tally["out"][2] += time.perf_counter() - t0
        tally["out"][0] += 1
        tally["out"][1] += len(blocks)
        idx = torch.tensor(blocks, dtype=torch.long, device=eng.device)
        tally["equal"] &= all(torch.equal(pool[:, idx].cpu(), payload[n])
                              for n, pool in eng.cache.items())
        return payload

    def pages_from_host(blocks, payload):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        from_host(blocks, payload)
        torch.cuda.synchronize()
        tally["in"][2] += time.perf_counter() - t0
        tally["in"][0] += 1
        tally["in"][1] += len(blocks)
        idx = torch.tensor(blocks, dtype=torch.long, device=eng.device)
        tally["equal"] &= all(torch.equal(pool[:, idx].cpu(), payload[n])
                              for n, pool in eng.cache.items())

    eng._pages_to_host = pages_to_host
    eng._pages_from_host = pages_from_host
    return tally


def phase_full_width_spec_swap(torch, dev, full):
    """gemma-2b at full width through speculative decoding, swap
    preemption and the host tier, each run with the launch counts set to
    0 just before it.  Returns {path: launch counts}."""
    import numpy as np
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.serving import PagedServingEngine
    cfg, params, prompts = full["cfg"], full["params"], full["prompts"]
    (B, P), G, BS = prompts.shape, 32, 16
    L = cfg.n_layers
    kw = dict(max_slots=B, block_size=BS, max_blocks_per_seq=-(-(P + G) // BS),
              device=dev)
    out = {}

    def run(label, waves, **ekw):
        eng = PagedServingEngine(cfg, params, **dict(kw, **ekw))
        tally = watch_host_copies(torch, eng)
        torch.cuda.synchronize()
        zero_counts(kernel)
        t0 = time.perf_counter()
        streams = serve(eng, waves)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts(kernel)
        out[label] = c
        m = eng.metrics()
        upd = c["int8"] if eng.kv_dtype == "int8" else c["fp"]
        n_tok = sum(len(t) for t in streams)
        log(f"[spec] {label}: {eng.dispatches} passes, {wall:.3f} s, "
            f"{n_tok / eng.dispatches:.3f} tokens a pass; launches {c} "
            f"({upd / max(1, eng.dispatches * L):g} update launches a pass "
            f"and layer)")
        if upd != L * eng.dispatches or upd == 0:
            raise AssertionError(f"{label}: the update kernel did not run "
                                 f"once per layer per pass")
        if c["copy"] != m["prefix_cache"]["cow_copies"]:
            raise AssertionError(f"{label}: {c['copy']} copy launches for "
                                 f"{m['prefix_cache']['cow_copies']} "
                                 f"copy-on-write copies")
        return eng, streams, m, tally, c

    waves = [[(row, G) for row in prompts]]
    # -- the non-speculative reference and its top-2 margins ------------
    _, base, _, _, _ = run("speculate=False, fp pages", waves)
    seq = torch.from_numpy(np.concatenate(
        [prompts, np.asarray(base, np.int32)], axis=1)).to(dev)
    margins = stepwise_margins(torch, dev, cfg, params, seq, P, BS)
    # -- speculation, both ticks, fp pages ----------------------------
    for unified in (True, False):
        tick = "unified" if unified else "two-dispatch"
        label = f"speculate, {tick} tick, fp pages"
        eng, streams, m, _, _ = run(label, waves, speculate=True, draft_k=4,
                                    unified=unified)
        sp = m["speculative"]
        log(f"[spec] {label}: drafted {sp['drafted_tokens']}, accepted "
            f"{sp['accepted_tokens']} (accept rate {sp['accept_rate']:.3f})")
        if not sp["drafted_tokens"] > 0:
            raise AssertionError(f"{label}: nothing was drafted")
        varied(label, streams)
        near_ties(label, streams, base, margins, P)
        out[label]["accept_rate"] = sp["accept_rate"]
        out[label]["tokens_per_pass"] = B * G / eng.dispatches
    # -- speculation over int8 pools with the prefix cache: the re-served
    # prompt recomputes its last token into a copy-on-write page --------
    waves8 = waves + [[(prompts[0].copy(), G)]]
    _, base8, _, _, _ = run("speculate=False, int8 pages, prefix cache",
                            waves8, kv_dtype="int8", prefix_cache=True)
    seq8 = torch.from_numpy(np.concatenate(
        [np.concatenate([prompts, prompts[:1]]), np.asarray(base8, np.int32)],
        axis=1)).to(dev)
    margins8 = stepwise_margins(torch, dev, cfg, params, seq8, P, BS,
                                kv_dtype="int8")
    label = "speculate, unified tick, int8 pages, prefix cache"
    eng, streams, m, _, c = run(label, waves8, speculate=True, draft_k=4,
                                kv_dtype="int8", prefix_cache=True)
    sp, pc = m["speculative"], m["prefix_cache"]
    log(f"[spec] {label}: drafted {sp['drafted_tokens']}, accepted "
        f"{sp['accepted_tokens']} (accept rate {sp['accept_rate']:.3f}); "
        f"prefix hits {pc['hit_tokens']}, copy-on-write copies "
        f"{pc['cow_copies']}")
    if not (sp["drafted_tokens"] > 0 and pc["cow_copies"] > 0
            and c["copy"] == pc["cow_copies"]):
        raise AssertionError(f"{label}: no draft, or not one copy_pages "
                             f"launch a copy-on-write")
    varied(label, streams)
    near_ties(label, streams, base8, margins8, P)
    # -- swap preemption: 12 usable pages for 4 requests of 4 pages ------
    label = "preempt=swap, 12 usable pages"
    eng, streams, m, tally, _ = run(label, waves, preempt="swap",
                                    num_blocks=13)
    u = m["blocks"]
    n_out, p_out, s_out = tally["out"]
    n_in, p_in, s_in = tally["in"]
    page_bytes = sum(pool[:, 0].numel() * pool.element_size()
                     for pool in eng.cache.values())
    log(f"[spec] {label}: preemptions {m['scheduler']['preemptions']}, "
        f"swapped out {u['swapped_out_pages']} / in {u['swapped_in_pages']} "
        f"pages, host pages after the drain {u['host_pages']}; {n_out} "
        f"copies out ({p_out} pages, {1e3 * s_out / max(1, p_out):.4f} ms a "
        f"page), {n_in} in ({p_in} pages, {1e3 * s_in / max(1, p_in):.4f} "
        f"ms a page), {page_bytes} bytes a page (every layer, K and V); "
        f"parked and restored pages bit-equal {tally['equal']}")
    if not (u["swapped_out_pages"] > 0 and p_in == u["swapped_in_pages"]
            == u["swapped_out_pages"] and tally["equal"]
            and u["host_pages"] == 0):
        raise AssertionError(f"{label}: no swap, a page not restored "
                             f"bit-equal, or a payload left parked")
    varied(label, streams)
    near_ties(label, streams, base, margins, P)
    out[label]["ms_per_page_out"] = 1e3 * s_out / max(1, p_out)
    out[label]["ms_per_page_in"] = 1e3 * s_in / max(1, p_in)
    out[label]["pages"] = p_out
    # the host copies alone, over the drained engine's pools: n pages out
    # and back onto themselves, the median of 10 calls each (host clock
    # around blocking copies)
    for n in (1, 4, 12):
        blocks = list(range(1, n + 1))
        t_out, t_in = [], []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payload = PagedServingEngine._pages_to_host(eng, blocks)
            t1 = time.perf_counter()
            PagedServingEngine._pages_from_host(eng, blocks, payload)
            torch.cuda.synchronize()
            t_out.append(t1 - t0)
            t_in.append(time.perf_counter() - t1)
        ms = (1e3 * float(np.median(t_out)) / n,
              1e3 * float(np.median(t_in)) / n)
        log(f"[spec] host copies of {n} pages ({n * page_bytes} bytes), the "
            f"median of 10: out {ms[0]:.4f} ms a page "
            f"({page_bytes / ms[0] / 1e6:.2f} GB/s), in {ms[1]:.4f} ms "
            f"a page ({page_bytes / ms[1] / 1e6:.2f} GB/s)")
        out[label][f"copy_ms_per_page_{n}"] = ms
    # a speculative decode tick's breakdown, as phase 5's (160 tokens a
    # request, so that its 20 ticks of up to 5 tokens a request decode)
    tick_breakdown(torch, cfg, params, prompts, 160,
                   dict(kw, max_blocks_per_seq=-(-(P + 160) // BS),
                        speculate=True, draft_k=4),
                   label=" speculative (draft_k 4)")
    # -- the host tier: two prompts with a shared 48-token system prompt
    # and 112-token suffixes, the first re-served after the second
    # evicted its suffix pages from a pool of one request's 11 pages:
    # the re-serve restores them from host RAM.  One slot, chunks of 3,
    # as phase 5b's prefix-cache comparison, so both runs compute every
    # token in the same shapes ------------------------------------------
    rng = np.random.default_rng(3)
    sysp = rng.integers(0, cfg.vocab, 3 * BS, dtype=np.int32)
    two = [np.concatenate([sysp, rng.integers(0, cfg.vocab, 7 * BS,
                                              dtype=np.int32)])
           for _ in range(2)]
    hwaves = [[(two[0], 8)], [(two[1], 8)], [(two[0].copy(), 8)]]
    hkw = dict(max_slots=1, max_blocks_per_seq=11, num_blocks=12,
               prefill_chunk=3)
    _, off, _, _, _ = run("cache off, one slot, chunks of 3", hwaves, **hkw)
    label = "prefix cache + host tier (8 pages), one slot, chunks of 3"
    eng, on, m, tally, c = run(label, hwaves, prefix_cache=True,
                               host_cache_pages=8, **hkw)
    u, pc = m["blocks"], m["prefix_cache"]
    log(f"[spec] {label}: spills {u['host_cache_spills']}, host restores "
        f"{u['host_cache_hits']} ({tally['in'][1]} pages copied back, "
        f"{1e3 * tally['in'][2] / max(1, tally['in'][1]):.4f} ms a page), "
        f"prefix hits {pc['hit_tokens']} of {pc['lookup_tokens']} tokens, "
        f"copy-on-write copies {pc['cow_copies']}; restored pages "
        f"bit-equal to the spilled bytes {tally['equal']}; streams "
        f"byte-equal to the cache off: {[a == b for a, b in zip(on, off)]}")
    if not (u["host_cache_hits"] > 0 and tally["equal"]):
        raise AssertionError(f"{label}: no prefix hit from host RAM, or a "
                             f"restored page differs from its spill")
    if on != off:
        raise AssertionError(f"{label}: streams differ from the cache off")
    varied(label, on)
    out[label]["host_restores"] = u["host_cache_hits"]
    return out


# ---------------------------------------------------------------------------
# phase 5c: the legacy engine, the open-loop front end, the router, sampling
# ---------------------------------------------------------------------------

def held_to(torch, dev, label, cfg, params, reqs, got, want, BS):
    """Hold served streams ``got`` to the reference streams ``want`` of
    the same requests ``reqs`` [(prompt, gen)]: each of ``gen`` tokens,
    equal, or leaving the reference first where its top-2 margin (the
    paged step, one token a step, over prompt + reference) is under
    ``SPEC_TIE``.  Margins are computed only for streams that leave it.
    Returns how many streams are identical."""
    import numpy as np
    exact = 0
    for b, ((p, g), gs, ws) in enumerate(zip(reqs, got, want)):
        if not len(gs) == len(ws) == g:
            raise AssertionError(f"{label}: request {b} served {len(gs)} "
                                 f"tokens, the reference {len(ws)}, asked "
                                 f"{g}: a dropped or duplicated token")
        t = next((i for i in range(g) if gs[i] != ws[i]), None)
        if t is None:
            exact += 1
            continue
        seq = torch.from_numpy(np.concatenate(
            [p, np.asarray(ws, np.int32)]))[None].to(dev)
        gap = stepwise_margins(torch, dev, cfg, params, seq, len(p),
                               BS)[0, len(p) + t - 1].item()
        log(f"[5c] {label}: request {b} first leaves the reference at "
            f"token {t}: its top-2 margin {gap:.4f} (a near-tie under "
            f"{SPEC_TIE:g})")
        if not gap < SPEC_TIE:
            raise AssertionError(f"{label}: request {b} diverges at token "
                                 f"{t} with a clear top-2 margin {gap}")
    log(f"[5c] {label}: {exact}/{len(want)} streams identical to the "
        f"reference")
    return exact


def closed_loop(cfg, params, reqs, **kw):
    """The streams of ``reqs`` [(prompt, gen)] pre-staged on one paged
    engine (``kw``), drained: the open-loop runs' reference."""
    from repro_torch.serving import PagedServingEngine
    eng = PagedServingEngine(cfg, params, **kw)
    ids = [eng.submit(p, g) for p, g in reqs]
    res = eng.run_to_completion()
    return [res[i] for i in ids]


def phase_frontends(torch, dev, full):
    """gemma-2b at full width through the legacy dense engine, the CLI's
    open-loop front end, two replicas behind the router on the one card
    (affinity and round-robin, then a replica failed mid-traffic) and
    temperature sampling, each run with the launch counts set to 0 just
    before it.  Returns {path: launch counts and numbers}."""
    import numpy as np
    from repro_torch.core.serving import ServingEngine
    from repro_torch.ft.preemption import PreemptionSchedule
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.launch import serve as cli
    from repro_torch.launch.serve import generate
    from repro_torch.serving import (PagedServingEngine, ReplicaRouter,
                                     ServingFrontend)
    from repro_torch.serving.loadgen import build_workload
    cfg, params, prompts = full["cfg"], full["params"], full["prompts"]
    (B, P), G, BS = prompts.shape, 32, 16
    L = cfg.n_layers
    t_phase = time.perf_counter()
    out = {}
    # -- (a) the legacy engine: 4 x (32 + 32), prefill token by token ----
    eng = ServingEngine(cfg, params, max_slots=B, max_seq=P + G + 1,
                        device=dev)
    torch.cuda.synchronize()
    zero_counts(kernel)
    t0 = time.perf_counter()
    ids = [eng.submit(row, G) for row in prompts]
    res = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts(kernel)
    got = [res[i] for i in ids]
    seq, top2 = generate(cfg, params, torch.from_numpy(prompts).to(dev), G,
                         return_top2=True)
    want = seq[:, P:].cpu().tolist()
    margins = torch.full((B, P + G), float("inf"))
    margins[:, P - 1:P - 1 + G] = (top2[..., 0] - top2[..., 1]).cpu()
    log(f"[5c] legacy engine: {B} requests x {G} tokens in {wall:.3f} s, "
        f"{B * G / wall:.1f} tokens/s, {eng.dispatches} decode dispatches "
        f"(one slot, one token each); kernel launches {c} (the dense "
        f"engine runs plain PyTorch)")
    if any(c.values()):
        raise AssertionError("legacy engine: a paged kernel was launched")
    varied("legacy engine", got)
    near_ties("legacy engine vs generate", got, want, margins, P)
    out["legacy engine"] = dict(c, tokens_per_s=B * G / wall, wall_s=wall)
    # -- (b) open loop through the CLI, on the wall clock ----------------
    base = ["--arch", cfg.name, "--device", str(dev), "--seed", "0"]
    argv = base + ["--open-loop", "--mix", "chat", "--arrivals", "poisson",
                   "--rate", "20", "--requests", "32", "--slo-ttft", "0.5",
                   "--slo-tpot", "0.05"]
    args = cli.parse_args(argv)
    wl = build_workload(mix=args.mix, arrivals=args.arrivals,
                        n=args.requests, seed=args.seed, vocab=cfg.vocab,
                        rate=args.rate)
    reqs = [(r.prompt, r.max_new_tokens) for r in wl]
    cap = max(p.size + g for p, g in reqs) + 1
    ekw = dict(max_slots=args.batch, block_size=args.block_size,
               max_blocks_per_seq=-(-cap // args.block_size), device=dev)
    torch.cuda.synchronize()
    zero_counts(kernel)
    report, streams = cli.run(cfg, params, args)
    c = counts(kernel)
    ol = report["open_loop"]
    log(f"[5c] open loop (serve {' '.join(argv[4:])}): "
        f"{ol['finished']}/{ol['requests']} finished in {report['wall_s']} "
        f"s, {report['tokens_per_s']} tokens/s; TTFT p50 "
        f"{ol['p50_ttft_s']:.4f} / p99 {ol['p99_ttft_s']:.4f} s, TPOT p50 "
        f"{ol['p50_tpot_s']:.4f} / p99 {ol['p99_tpot_s']:.4f} s; "
        f"throughput {ol['throughput_tok_s']:.1f}, goodput "
        f"{ol['goodput_tok_s']:.1f} tokens/s at the SLO (TTFT 0.5 s, TPOT "
        f"0.05 s; {ol['slo_frac']:.3f} of requests met it); "
        f"{ol['rounds']} rounds, overlap_admitted {ol['overlap_admitted']}; "
        f"{report['dispatches']} ticks, launches {c} "
        f"({c['fp'] / max(1, L * report['dispatches']):g} update launches "
        f"a tick and layer)")
    if c["fp"] != L * report["dispatches"] or c["fp"] == 0:
        raise AssertionError("open loop: the update kernel did not run "
                             "once per layer per tick")
    if c["copy"]:
        raise AssertionError("open loop: a copy launch without the prefix "
                             "cache")
    if ol["finished"] != len(wl):
        raise AssertionError("open loop: a request did not finish")
    got = [streams[f] for f in sorted(streams)]
    ref = closed_loop(cfg, params, reqs, **ekw)
    varied("open loop", got)
    held_to(torch, dev, "open loop vs closed loop", cfg, params, reqs, got,
            ref, BS)
    out["open loop"] = dict(c, ticks=report["dispatches"], **{
        k: ol[k] for k in ("p50_ttft_s", "p99_ttft_s", "p50_tpot_s",
                           "p99_tpot_s", "throughput_tok_s", "goodput_tok_s",
                           "slo_frac", "overlap_admitted")})
    # -- (c) two replicas on the one card, one weight set ----------------
    argv = base + ["--open-loop", "--mix", "agents", "--prefix-cache",
                   "--host-cache-pages", "16", "--replicas", "2"]
    wl = build_workload(mix="agents", n=32, seed=0, vocab=cfg.vocab,
                        rate=20.0)
    reqs = [(r.prompt, r.max_new_tokens) for r in wl]
    cap = max(p.size + g for p, g in reqs) + 1
    ekw = dict(ekw, max_blocks_per_seq=-(-cap // BS), prefix_cache=True,
               host_cache_pages=16)
    ref = closed_loop(cfg, params, reqs, **ekw)
    for routing in ("affinity", "rr"):
        label = f"router, 2 replicas, {routing}"
        args = cli.parse_args(argv + ["--routing", routing])
        torch.cuda.synchronize()
        zero_counts(kernel)
        report, streams = cli.run(cfg, params, args)
        c = counts(kernel)
        fl, ol = report["fleet"], report["open_loop"]
        ticks = sum(r["dispatches"] for r in report["replicas"])
        hits = [r["prefix_cache"]["hit_tokens"] for r in report["replicas"]]
        log(f"[5c] {label}: placements {fl['placements']}, "
            f"affinity_hit_tokens {fl['affinity_hit_tokens']}, prefix hits "
            f"by replica {hits}; {report['wall_s']} s, "
            f"{report['tokens_per_s']} tokens/s, TTFT p50 "
            f"{ol['p50_ttft_s']:.4f} / p99 {ol['p99_ttft_s']:.4f} s; "
            f"{ticks} replica ticks, launches {c}")
        if c["fp"] != L * ticks or c["fp"] == 0:
            raise AssertionError(f"{label}: the update kernel did not run "
                                 f"once per layer per replica tick")
        cow = sum(r["prefix_cache"]["cow_copies"] for r in report["replicas"])
        if c["copy"] != cow:
            raise AssertionError(f"{label}: {c['copy']} copy launches for "
                                 f"{cow} copy-on-write copies")
        got = [streams[f] for f in sorted(streams)]
        held_to(torch, dev, f"{label} vs one engine", cfg, params, reqs,
                got, ref, BS)
        out[label] = dict(c, ticks=ticks, prefix_hit_tokens=sum(hits),
                          placements=fl["placements"],
                          affinity_hit_tokens=fl["affinity_hit_tokens"],
                          p50_ttft_s=ol["p50_ttft_s"],
                          p99_ttft_s=ol["p99_ttft_s"],
                          tokens_per_s=report["tokens_per_s"])
    if not out["router, 2 replicas, affinity"]["affinity_hit_tokens"] > 0:
        raise AssertionError("router: affinity placed nothing by prefix")
    # a replica killed at tick 10 (the router's injected preemption, which
    # calls fail_replica) while the front end serves the same traffic
    label = "router, 2 replicas, a replica failed at tick 10"
    retired = []

    def build(i):
        return PagedServingEngine(cfg, params, **ekw)

    rt = ReplicaRouter(build, 2, routing="affinity",
                       preemption=PreemptionSchedule(kill_at_steps=[10]),
                       retire=retired.append)
    fe = ServingFrontend(rt)
    torch.cuda.synchronize()
    zero_counts(kernel)
    fids = fe.submit_workload(wl)
    fe.drain()
    torch.cuda.synchronize()
    c = counts(kernel)
    ticks = sum(e.dispatches for e in rt.replicas + retired)
    got = [fe.result(f).tokens for f in fids]
    log(f"[5c] {label}: failures {rt.replica_failures}, re-routed "
        f"{rt.rerouted_total} requests, migrated {rt.migrated_pages} pages "
        f"to the survivor's host tier; {ticks} replica ticks, launches {c}")
    if not (rt.replica_failures == 1 and rt.rerouted_total > 0):
        raise AssertionError(f"{label}: no replica failed with requests "
                             f"on it")
    if c["fp"] != L * ticks:
        raise AssertionError(f"{label}: the update kernel did not run once "
                             f"per layer per replica tick")
    cow = sum(e.metrics()["prefix_cache"]["cow_copies"]
              for e in rt.replicas + retired)
    if c["copy"] != cow:
        raise AssertionError(f"{label}: {c['copy']} copy launches for {cow} "
                             f"copy-on-write copies")
    held_to(torch, dev, label, cfg, params, reqs, got, ref, BS)
    out[label] = dict(c, ticks=ticks, rerouted=rt.rerouted_total,
                      migrated_pages=rt.migrated_pages)
    # -- (d) sampling at temperature 0.7 through the CLI, twice ----------
    argv = base + ["--engine", "batch", "--temperature", "0.7"]
    runs = [cli.run(cfg, params, cli.parse_args(argv))[1] for _ in range(2)]
    greedy = cli.run(cfg, params, cli.parse_args(base + ["--engine",
                                                         "batch"]))[1]
    sampled = runs[0][:, P:].cpu().tolist()
    same = torch.equal(runs[0], runs[1])
    off = sum(a != b for s, g in zip(sampled, greedy[:, P:].cpu().tolist())
              for a, b in zip(s, g))
    log(f"[5c] sampling at temperature 0.7 (serve --engine batch, seed 0), "
        f"twice: streams equal {same}; {off} of {B * G} tokens differ from "
        f"greedy; distinct tokens per stream "
        f"{[len(set(s)) for s in sampled]}")
    if not same or off == 0:
        raise AssertionError("sampling: a seeded generator gave two "
                             "streams, or sampling gave the greedy stream")
    log(f"[5c] phase 5c took {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phases 5d and 5e: the MoE stack (olmoe-1b-7b) and the other configs
# ---------------------------------------------------------------------------

def scaled_model(torch, dev, name, n_layers=None):
    """``name``'s config at full published width (``n_layers`` cuts its
    depth) with random weights from seed 0 on the card, both output
    projections (attention's and the MLP's or every expert's ``wo``)
    scaled by ``BRANCH_GAIN * sqrt(d_model)`` as phase 5 scales
    gemma-2b's.  Under a final-logit softcap (grok-1-314b) the final
    norm's scale is cut so the logits have a std of a third of the cap
    before it: random tied embeddings give logits of std sqrt(d_model),
    which the cap would flatten into ties.  Returns (cfg, params)."""
    import dataclasses
    from repro_torch.config import get_config
    from repro_torch.models import model as M
    cfg = get_config(name)
    cut = ""
    if n_layers is not None:
        cut = f", depth cut from {cfg.n_layers} to {n_layers} layers"
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device=dev)
    gain = BRANCH_GAIN * cfg.d_model ** 0.5
    params["layers"]["attn"]["wo"].mul_(gain)
    params["layers"]["moe" if cfg.moe else "mlp"]["wo"].mul_(gain)
    if cfg.logit_softcap:
        s = cfg.logit_softcap / 3 / cfg.d_model ** 0.5
        params["final_ln"]["scale"].mul_(s)
        cut += (f", final norm x{s:.4f} (logits of std "
                f"{cfg.logit_softcap / 3:g} before the softcap "
                f"{cfg.logit_softcap:g})")
    torch.cuda.synchronize()
    log(f"[{name}] {M.count_params(cfg) / 1e9:.3f} B parameters "
        f"({cfg.dtype}) initialised in {time.perf_counter() - t0:.1f} s, "
        f"output projections x{gain:.2f}{cut}")
    return cfg, params


def dropless(cfg):
    """``cfg`` with ``capacity_factor`` raised to E / k, so that every
    expert's buffer holds every token (C >= T for any T): the MoE output
    of a token then depends on that token alone, as exactness needs."""
    import dataclasses
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    cf = m.num_experts / m.top_k
    log(f"[{cfg.name}] exactness checks under the dropless override: "
        f"capacity_factor {m.capacity_factor:g} -> {cf:g} (E {m.num_experts}"
        f" / k {m.top_k})")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=cf))


def served(torch, eng, prompts, G):
    """:func:`serve` ``prompts`` (B, P) for ``G`` tokens each as one wave;
    returns (streams in submission order, wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = serve(eng, [[(row, G) for row in prompts]])
    torch.cuda.synchronize()
    return streams, time.perf_counter() - t0


def held_at_full_width(torch, dev, tag, cfg, params, prompts, streams, BS):
    """Phase 5's checks on a config's fp-page streams: the streams vary,
    the paged step's teacher-forced logits lie within ``TF_RATIO`` of the
    bf16 oracle's own distance from fp32, and each stream equals
    ``generate``'s up to a first divergence at a near-tie.  Returns the
    teacher-forced numbers."""
    from repro_torch.launch.serve import generate
    B, P = prompts.shape
    G = len(streams[0])
    varied(f"{cfg.name} fp pages", streams)
    seq, top2 = generate(cfg, params, torch.from_numpy(prompts).to(dev), G,
                         return_top2=True)
    toks, top2 = seq[:, P:].cpu().tolist(), top2.cpu()
    log(f"{tag} generate: distinct tokens per stream "
        f"{[len(set(r)) for r in toks]}, smallest top-2 logit gap "
        f"{(top2[..., 0] - top2[..., 1]).min().item():.4f}")
    tf_err, paged_err, own_err = teacher_forced(torch, dev, cfg, params,
                                                seq, P, BS)
    log(f"{tag} teacher-forced logits over {B}x{P + G} positions: "
        f"max|paged - generate's bf16| {tf_err:.4f}; against fp32: paged "
        f"{paged_err:.4f}, generate's bf16 {own_err:.4f} (allowed "
        f"{TF_RATIO:g}x)")
    if not paged_err <= TF_RATIO * own_err:
        raise AssertionError(f"{tag} the paged step's logits are further "
                             f"from fp32 than bf16 rounding explains")
    exact = held_to_generate(tag, streams, toks, top2, 2 * tf_err)
    return dict(tf_err=tf_err, paged_err=paged_err, own_err=own_err,
                exact=exact)


def cast_fp32(tree):
    """Cast every leaf of ``tree`` to fp32 in place, one leaf at a time,
    so the bf16 and fp32 copies of the whole model never coexist."""
    for k, v in tree.items():
        if isinstance(v, dict):
            cast_fp32(v)
        else:
            tree[k] = v.float()


def held_in_fp32(torch, dev, tag, cfg, params, prompts, G, kw):
    """The same weights in fp32 (``params`` cast in place): the engine over
    fp32 pages, the fp32 walk launching once per layer per tick; each
    stream identical to fp32 ``generate``'s or leaving it at a top-2 gap
    under ``FP32_TIE``; teacher-forced, the paged step's logits within
    ``FP32_TF`` of the largest fp32 ``forward`` logit.  bf16 rounding
    flips MoE routing at near-ties between any two paths, which the bf16
    checks must allow for; in fp32 such flips are rare enough to hold
    the paths to each other.  Returns the launch counts."""
    import dataclasses
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.launch.serve import generate
    from repro_torch.serving import PagedServingEngine
    cast_fp32(params)
    c32 = dataclasses.replace(cfg, dtype="float32")
    B, P = prompts.shape
    eng = PagedServingEngine(c32, params, **kw)
    zero_counts(kernel)
    streams, wall = served(torch, eng, prompts, G)
    c = counts(kernel)
    per_pass = c32.n_layers * eng.dispatches
    log(f"{tag} fp32 weights and pages: {eng.dispatches} ticks, {wall:.3f} "
        f"s; launches {c} (n_layers {c32.n_layers} x dispatches "
        f"{eng.dispatches} = {per_pass})")
    if not c["fp"] == per_pass > 0:
        raise AssertionError(f"{tag} fp32: the update did not launch once "
                             f"per layer per tick")
    seq, top2 = generate(c32, params, torch.from_numpy(prompts).to(dev), G,
                         return_top2=True)
    toks, top2 = seq[:, P:].cpu().tolist(), top2.cpu()
    paged = paged_logits(torch, dev, c32, params, seq, P, kw["block_size"])
    ref = forward_f32(torch, c32, params, seq)
    err, scale = (paged - ref).abs().max().item(), ref.abs().max().item()
    log(f"{tag} fp32 teacher-forced over {B}x{seq.shape[1]} positions: "
        f"max|paged - forward| {err:.3e}, largest logit {scale:.3f} "
        f"(allowed {FP32_TF:g} of it)")
    if not err <= FP32_TF * scale:
        raise AssertionError(f"{tag} fp32: the paged step's logits leave "
                             f"the fp32 forward's")
    held_to_generate(f"{tag} fp32", streams, toks, top2, FP32_TIE)
    return c


def expert_bytes(cfg):
    """Bytes of every expert matrix of the stack (bf16): what a decode
    tick reads when every expert runs, whatever the batch."""
    m = cfg.moe
    mats = 3 if cfg.act in ("swiglu", "geglu") else 2
    return cfg.n_layers * m.num_experts * mats * cfg.d_model * m.d_ff * 2


@contextlib.contextmanager
def drop_tally(torch, dev):
    """While active, each ``moe.apply_moe`` call also routes its input once
    more (``moe.route``, a side call) and adds the assignments its capacity
    drops and all its assignments to the yielded (2,) tensor; the engine
    itself counts nothing."""
    from repro_torch.models import moe
    orig = moe.apply_moe
    tally = torch.zeros(2, dtype=torch.int64, device=dev)

    def counted(p, x, cfg, cap=None):
        T = x.shape[0] * x.shape[1]
        r = moe.route(p["router"], x.reshape(T, -1), cfg,
                      cap if cap is not None else moe.capacity(T, cfg))
        tally[0] += (~r.keep).sum()
        tally[1] += r.keep.numel()
        return orig(p, x, cfg, cap)

    moe.apply_moe = counted
    try:
        yield tally
    finally:
        moe.apply_moe = orig


def phase_moe_full_width(torch, dev, worst):
    """olmoe-1b-7b at full width (16 layers, d 2048, 16 heads of 128, 64
    experts top-8, d_ff 1024, vocab 50304, bf16) through the unified tick,
    each run with the launch counts set to 0 just before it: fp pages,
    int8 pages and the prefix cache under the dropless override, held as
    phase 5 holds gemma-2b; then the published capacity factor: the
    dropped share and a decode tick's breakdown.  Returns {path: launch
    counts}."""
    import numpy as np
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.serving import PagedServingEngine
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    name = "olmoe-1b-7b"
    tag = f"[{name}]"
    cfg_pub, params = scaled_model(torch, dev, name)
    cfg = dropless(cfg_pub)
    L = cfg.n_layers
    B, P, G, BS = 4, 32, 32, 16
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (B, P),
                                                dtype=np.int32)
    kw = dict(max_slots=B, block_size=BS, max_blocks_per_seq=-(-(P + G) // BS),
              device=dev)
    warm = PagedServingEngine(cfg, params, **kw)
    warm.submit(prompts[0], 4)
    warm.run_to_completion()
    del warm
    out = {}

    def drive(eng, label):
        """Serve the batch; mid-decode, hold the read-only walk against
        plain over the pools (layers 0 and L-1)."""
        ids = [eng.submit(row, G) for row in prompts]
        while any(ph != "decode" for ph in eng.slot_phase):
            eng.step()
        for _ in range(3):
            eng.step()
        readonly_over_engine(torch, dev, eng, f"{name} {label}", worst)
        res = eng.run_to_completion()
        return [res[i] for i in ids]

    # -- fp pages, then int8 pages: the update once per layer per tick,
    # the read-only walk twice a run ------------------------------------
    streams = {}
    for kv, key in ((None, "fp"), ("int8", "int8")):
        eng = PagedServingEngine(cfg, params, kv_dtype=kv, **kw)
        torch.cuda.synchronize()
        zero_counts(kernel)
        streams[key] = drive(eng, key)
        c = counts(kernel)
        per_pass = L * eng.dispatches
        log(f"{tag} {key} pages: {B} requests x {G} tokens in "
            f"{eng.dispatches} ticks; launches {c} (the D 128 {key} update:"
            f" n_layers {L} x dispatches {eng.dispatches} = {per_pass}; "
            f"the read-only walk 2)")
        other = "int8" if key == "fp" else "fp"
        if not (c[key] == per_pass > 0 and c[other] == 0
                and c["readonly"] == 2):
            raise AssertionError(f"{tag} {key} pages: the update did not "
                                 f"launch once per layer per tick")
        if [len(s) for s in streams[key]] != [G] * B:
            raise AssertionError(f"{tag} {key} pages: a request did not "
                                 f"finish")
        out[f"{name} {key}"] = c
    varied(f"{name} int8 pages", streams["int8"])
    held = held_at_full_width(torch, dev, tag, cfg, params, prompts,
                              streams["fp"], BS)
    # -- the prefix cache: two 48-token system prompts, each with two
    # 16-token suffixes, and one prompt re-served in full (its last token
    # recomputed into a copy-on-write page).  160-token prompts as in
    # phase 5b leave this random model's streams nearly constant.  One
    # slot and chunks of 3, so both runs compute every token in the same
    # shapes: chunk bounds fall on 48, where a hit's prefill starts, and
    # on 63, the re-served prompt's last token -------------------------
    rng = np.random.default_rng(2)
    systems = [rng.integers(0, cfg.vocab, 3 * BS, dtype=np.int32)
               for _ in range(2)]
    shared = [np.concatenate([sysp, rng.integers(0, cfg.vocab, BS,
                                                 dtype=np.int32)])
              for sysp in systems for _ in range(2)]
    waves = [[(p, 16)] for p in shared] + [[(shared[0].copy(), 16)]]
    pkw = dict(kw, max_slots=1, max_blocks_per_seq=-(-(4 * BS + 16) // BS),
               num_blocks=64, prefill_chunk=3)
    runs = {}
    for pc in (False, True):
        eng = PagedServingEngine(cfg, params, prefix_cache=pc, **pkw)
        torch.cuda.synchronize()
        zero_counts(kernel)
        runs[pc] = (serve(eng, waves), counts(kernel),
                    eng.metrics()["prefix_cache"])
    (off, _, _), (on, c, m) = runs[False], runs[True]
    log(f"{tag} prefix cache: hits {m['hit_tokens']} of "
        f"{m['lookup_tokens']} prompt tokens, copy-on-write copies "
        f"{m['cow_copies']}, launches {c}; streams byte-equal to the cache "
        f"off: {[a == b for a, b in zip(on, off)]}")
    if on != off:
        raise AssertionError(f"{tag} prefix cache: streams differ from the "
                             f"cache off")
    varied(f"{name} prefix cache", on)
    if not (m["hit_tokens"] > 0 and m["cow_copies"] > 0
            and c["copy"] == m["cow_copies"]):
        raise AssertionError(f"{tag} prefix cache: no hit, or not one "
                             f"copy_pages launch a copy-on-write")
    out[f"{name} prefix cache"] = c
    # -- the published capacity factor: drops, then the tick ----------------
    eng = PagedServingEngine(cfg_pub, params, **kw)
    with drop_tally(torch, dev) as tally:
        streams, wall = served(torch, eng, prompts, G)
    dropped, total = tally.tolist()
    log(f"{tag} capacity_factor {cfg_pub.moe.capacity_factor:g}: {B} "
        f"requests x {G} tokens in {eng.dispatches} ticks, {wall:.3f} s "
        f"({B * G / wall:.1f} tokens/s); {dropped} of {total} assignments "
        f"dropped ({dropped / total:.4f}; rows of the padded buckets "
        f"included), served {[len(s) for s in streams]}")
    if [len(s) for s in streams] != [G] * B:
        raise AssertionError(f"{tag} published capacity: a request did not "
                             f"finish")
    tick = tick_breakdown(torch, cfg_pub, params, prompts, G, kw)
    eb = expert_bytes(cfg_pub)
    log(f"{tag} every expert runs at C >= 8 every tick: {eb / 1e9:.2f} GB "
        f"of expert weights a tick ({eb / L / 1e6:.0f} MB a layer), at "
        f"least {eb / HBM_BYTES_PER_S * 1e3:.3f} ms at "
        f"{HBM_BYTES_PER_S / 1e12:g} TB/s; the products took "
        f"{tick['bmm_ms']:.3f} ms")
    out[f"{name} fp32"] = held_in_fp32(torch, dev, tag, cfg, params,
                                       prompts, G, kw)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag} phase 5d: {time.perf_counter() - t_phase:.1f} s, peak "
        f"memory {peak:.1f} GiB")
    del params
    torch.cuda.empty_cache()
    return out, dict(held, dropped=dropped, assignments=total, tick=tick)


# (name, layers or None for all, prompt length): phase 5e's configs
OTHER_CONFIGS = (("glm4-9b", None, 32), ("gemma3-4b", None, 1100),
                 ("grok-1-314b", 2, 32))


def phase_other_configs(torch, dev):
    """glm4-9b (40 layers), gemma3-4b (34 layers; 1100-token prompts cross
    its 1024-token window) and grok-1-314b (full width, depth cut to 2 of
    64 layers: one card holds about 7 in bf16, a layer's experts taking
    9.66 GB) through the unified tick over fp pages, 4 requests x 32
    tokens each, the launch counts set to 0 just before each: the update
    launches once per layer per tick, and phase 5's checks hold (grok
    under the dropless override).  Then a decode tick's breakdown.
    Returns {path: launch counts}."""
    import numpy as np
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.serving import PagedServingEngine
    out, numbers = {}, {}
    for name, n_layers, P in OTHER_CONFIGS:
        t_phase = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        tag = f"[{name}]"
        cfg_pub, params = scaled_model(torch, dev, name, n_layers)
        cfg = dropless(cfg_pub)
        L, B, G, BS = cfg.n_layers, 4, 32, 16
        prompts = np.random.default_rng(1).integers(0, cfg.vocab, (B, P),
                                                    dtype=np.int32)
        kw = dict(max_slots=B, block_size=BS,
                  max_blocks_per_seq=-(-(P + G) // BS), device=dev)
        warm = PagedServingEngine(cfg, params, **kw)
        warm.submit(prompts[0, :32], 4)
        warm.run_to_completion()
        del warm
        eng = PagedServingEngine(cfg, params, **kw)
        zero_counts(kernel)
        streams, wall = served(torch, eng, prompts, G)
        c = counts(kernel)
        per_pass = L * eng.dispatches
        log(f"{tag} fp pages: {B} requests x (prompt {P} + {G}) in "
            f"{eng.dispatches} ticks, {wall:.3f} s; head_dim "
            f"{cfg.head_dim}, {cfg.n_heads} heads over {cfg.n_kv_heads}, "
            f"window {cfg.sliding_window or 'none'}, softcap "
            f"{cfg.attn_logit_softcap:g}; launches {c} (n_layers {L} x "
            f"dispatches {eng.dispatches} = {per_pass})")
        if not (c["fp"] == per_pass > 0):
            raise AssertionError(f"{tag} the update did not launch once per "
                                 f"layer per tick")
        out[f"{name} fp"] = c
        held = held_at_full_width(torch, dev, tag, cfg, params, prompts,
                                  streams, BS)
        tick = tick_breakdown(torch, cfg_pub, params, prompts, G, kw)
        out[f"{name} fp32"] = held_in_fp32(torch, dev, tag, cfg, params,
                                           prompts, G, kw)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"{tag} phase 5e: {time.perf_counter() - t_phase:.1f} s, peak "
            f"memory {peak:.1f} GiB")
        numbers[name] = dict(held, tick=tick)
        del params, eng
        torch.cuda.empty_cache()
    return out, numbers


# ---------------------------------------------------------------------------
# phase 6: timing
# ---------------------------------------------------------------------------

def device_ms(torch, fn, reps=50, warmup=5):
    """Device milliseconds per call: the summed device time of every
    kernel and copy ``fn`` puts on the card (``torch.profiler``), over
    ``reps`` calls.  The host's time to issue them is not in it."""
    for _ in range(warmup):
        fn()
    rows = profiled(torch, fn, reps)
    return sum(r[0] for r in rows) / reps / 1e3


def card_ms(torch, fn, reps=50, label=""):
    """Device milliseconds per call: the median of ``event_ms`` (CUDA
    events around each call, behind a queued sleep).  The host must issue
    every call inside the sleep, and the card's launch queue must hold
    them all, so a call slow to issue or made of many launches (a plain
    version) is timed over fewer calls: as many as the host issues in 20
    ms, and a third as many again each time the queue did not hold, down
    to 2."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    issue_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    reps = max(2, min(reps, int(0.02 / issue_s)))
    while True:
        med, _, _, held = event_ms(torch, fn, reps)
        if held:
            return med
        if reps == 2:
            raise AssertionError(f"timing {label}: the queue never held")
        log(f"[time] {label}: the card drained its queue before the host "
            f"issued the last of {reps} calls; again with fewer")
        reps = max(2, reps // 3)


def bound(torch, c, *, fresh=True, row_bytes=None):
    """Least time for the call's work on an H100 SXM: each byte the
    function needs read once and each output byte written once, or the
    operations the live query rows need (4*D per key: QK and PV) at the
    input type's peak, whichever is larger.  Bytes: the cached K/V rows
    the queries reach (with ``fresh``, those before a request's first
    fresh position; read-only, every row up to its last position; within
    the window), q in and out, the live fresh rows in and into the pools,
    the tables and positions; padded rows move no K/V.  ``row_bytes``:
    bytes of one pool row of one kv head (D * itemsize for fp pools,
    D + 4 for int8 rows and their fp32 scale)."""
    B, S, H, D = c["q"].shape
    Hkv = c["kp"].shape[2]
    item = c["q"].element_size()
    row_bytes = D * item if row_bytes is None else row_bytes
    pos = c["pos"].long()
    live = pos >= 0
    n_fresh = int(live.sum()) if fresh else 0
    first = torch.where(live, pos, FULL).min(dim=1).values
    first = torch.where(live.any(dim=1), first, 0)
    end = first if fresh else (pos.max(dim=1).values + 1).clamp(min=0)
    cached = (end - (first - c["window"] + 1).clamp(min=0)).clamp(min=0)
    nbytes = (2 * int(cached.sum()) * Hkv * row_bytes   # cached K, V read
              + 2 * B * S * H * D * item                 # q in, out
              + 2 * n_fresh * Hkv * (D * item + row_bytes)   # fresh in, out
              + 4 * (c["tables"].numel() + c["pos"].numel()))
    keys = (pos + 1).clamp(min=0, max=c["window"])       # keys per query row
    ops = 4 * D * H * int(keys.sum())
    dt = str(c["q"].dtype).split(".")[-1]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# phase 6 and 6b, glm4-9b's decode at head_dim 128: 4 requests, 32 heads
# over 2 kv heads, bf16, block 16
GLM4_DECODE = dict(B=4, S=1, starts=[48, 52, 60, 63], ns=[1, 1, 1, 1], H=32,
                   Hkv=2, D=128, BS=16, dtype="bfloat16")


def timing_shapes(torch, kernel):
    """Phase 6's shapes: gemma-2b decode and prefill, and glm4-9b decode
    at head_dim 128 where the tree's walk admits it (a parent tree timed
    by ``--timing-only --src`` may not)."""
    gemma = dict(H=8, Hkv=1, D=256, BS=16, dtype=torch.bfloat16)
    shapes = {"decode": dict(B=4, S=1, starts=[48, 52, 60, 63],
                             ns=[1, 1, 1, 1], **gemma),
              "prefill": dict(B=4, S=16, starts=[16, 0, 32, 48],
                              ns=[16, 16, 16, 16], **gemma)}
    if 128 in kernel.HEAD_DIMS:
        shapes["decode D128"] = dict(GLM4_DECODE, dtype=torch.bfloat16)
    else:
        log("[time] this tree's walk does not admit head_dim 128: no D 128 "
            "rows")
    return shapes


def phase_timing(torch, dev):
    from repro_torch.kernels.paged_attention import kernel, ref
    shapes = timing_shapes(torch, kernel)
    out = {}
    for label, shape in shapes.items():
        c = make_case(torch, dev, 7, **shape)
        kp, vp = c["kp"].clone(), c["vp"].clone()

        def run(fn):
            return lambda: fn(c["q"], c["kn"], c["vn"], kp, vp, c["tables"],
                              c["pos"], window=FULL, softcap=0.0,
                              max_live_blocks=c["live"])

        ms = card_ms(torch, run(kernel.paged_attention_update), label=label)
        plain_ms = card_ms(torch, run(ref.unified_attention_update),
                           label=label)
        library_ms = card_ms(torch, library_sdpa(torch, c, kp, vp),
                             label=label)
        bound_ms, bound_by = bound(torch, c)
        out[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        log(f"[time] {label} {tuple(c['q'].shape)} bf16, kv heads "
            f"{c['kp'].shape[2]}, CUDA events per call: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by})")
    return out


def library_sdpa(torch, c, kp, vp, ks=None, vs=None, gather=False):
    """The library yardstick of a walk: one ``scaled_dot_product_attention``
    call over the request's pages, gathered (and dequantized to q's dtype
    for int8 pools, and with GQA repeated to every query head) beforehand,
    outside the timed call; with ``gather``, the gather, the dequantize and
    the repeat inside the timed call as well."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ref
    B, S, H, D = c["q"].shape
    BS, Hkv = kp.shape[1], kp.shape[2]
    L = c["live"] * BS
    tab = c["tables"][:, :c["live"]].long()
    mask = (torch.arange(L, device=kp.device)[None, None, :]
            <= c["pos"].long()[:, :, None])[:, None]         # (B, 1, S, L)
    qt = c["q"].transpose(1, 2)

    def pages():
        if ks is not None:
            k, v = ref.dequantize(kp[tab], ks[tab]), ref.dequantize(
                vp[tab], vs[tab])
        else:
            k, v = kp[tab], vp[tab]
        k = k.to(c["q"].dtype).reshape(B, L, Hkv, D).transpose(1, 2)
        v = v.to(c["q"].dtype).reshape(B, L, Hkv, D).transpose(1, 2)
        if Hkv == 1:                                       # MQA: one head
            return k.expand(B, H, L, D), v.expand(B, H, L, D)
        return (k.repeat_interleave(H // Hkv, dim=1),       # GQA
                v.repeat_interleave(H // Hkv, dim=1))

    if gather:
        return lambda: F.scaled_dot_product_attention(qt, *pages(),
                                                      attn_mask=mask)
    kt, vt = pages()
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask)


def phase_family_timing(torch, dev):
    """Device time per call (CUDA events) of the int8 update, the read-only
    walk and copy_page at their full-width paths' shapes, beside the bound,
    the plain version and a library call (the int8 update: SDPA on pages
    gathered and dequantized beforehand, and with the gather and the
    dequantize timed too)."""
    from repro_torch.kernels.paged_attention import kernel, ref
    shapes = timing_shapes(torch, kernel)
    out = {}
    for label, shape in shapes.items():
        c = quantized(torch, make_case(torch, dev, 7, **shape))
        kq, vq, ks, vs = (c[n].clone() for n in ("kq", "vq", "ks", "vs"))

        def run(fn):
            return lambda: fn(c["q"], c["kn"], c["vn"], kq, vq, c["tables"],
                              c["pos"], window=FULL, softcap=0.0,
                              max_live_blocks=c["live"], k_scale=ks,
                              v_scale=vs)

        D = shape["D"]
        tag = f"int8 {label}"
        row = dict(ms=card_ms(torch, run(kernel.paged_attention_update),
                              label=tag),
                   plain_ms=card_ms(torch, run(ref.unified_attention_update),
                                    label=tag),
                   library_ms=card_ms(torch, library_sdpa(
                       torch, c, kq, vq, ks, vs), label=tag),
                   library_gather_ms=card_ms(torch, library_sdpa(
                       torch, c, kq, vq, ks, vs, gather=True), label=tag))
        row["bound_ms"], row["bound_by"] = bound(torch, c, row_bytes=D + 4)
        out[tag] = row
        log(f"[time] int8 update {label} {tuple(c['q'].shape)} bf16 q, int8 "
            f"pools, CUDA events per call: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, sdpa on dequantized pages "
            f"{row['library_ms']:.4f} ms, gather + dequantize + sdpa "
            f"{row['library_gather_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    for dec in [d for d in ("decode", "decode D128") if d in shapes]:
        c = quantized(torch, make_case(torch, dev, 8, **shapes[dec]))
        for quant in (False, True):
            kw = dict(k_scale=c["ks"], v_scale=c["vs"]) if quant else {}
            kp, vp = (c["kq"], c["vq"]) if quant else (c["kp"], c["vp"])

            def run(fn):
                return lambda: fn(c["q"], kp, vp, c["tables"], c["pos"],
                                  window=FULL, softcap=0.0,
                                  max_live_blocks=c["live"], **kw)

            tag = f"read-only {'int8' if quant else 'fp'}" + dec[6:]
            row = dict(ms=card_ms(torch, run(kernel.paged_attention),
                                  label=tag),
                       plain_ms=card_ms(torch, run(ref.paged_attention),
                                        label=tag),
                       library_ms=card_ms(torch, library_sdpa(
                           torch, c, kp, vp, *kw.values()), label=tag))
            row["bound_ms"], row["bound_by"] = bound(
                torch, c, fresh=False,
                row_bytes=shapes[dec]["D"] + 4 if quant else None)
            out[tag] = row
            log(f"[time] read-only walk, {'int8' if quant else 'fp'} pools, "
                f"{dec} {tuple(c['q'].shape)} bf16 q, kv heads "
                f"{kp.shape[2]}, CUDA events per call: kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
                f"({row['bound_by']})")
    # copy_page on gemma-2b's K pool at batch 4 (18 layers, 17 pages)
    g = torch.Generator(device=dev).manual_seed(9)
    pool = torch.randn((18, 17, 16, 1, 256), generator=g,
                       device=dev).to(torch.bfloat16)
    ids = torch.tensor([3, 7], dtype=torch.int32, device=dev)
    dst = torch.tensor([7], device=dev)
    page_bytes = pool[0, 0].numel() * pool.element_size()
    row = dict(ms=card_ms(torch, lambda: kernel.copy_page(pool, ids),
                          label="copy_page"),
               plain_ms=card_ms(torch, lambda: ref.copy_page(pool, 3, 7),
                                label="copy_page"),
               library_ms=card_ms(torch, lambda: pool.index_copy_(
                   1, dst, pool[:, 3:4]), label="copy_page"),
               bound_ms=2 * 18 * page_bytes / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes")
    out["copy_page"] = row
    log(f"[time] copy_page bf16 pool (18, 17, 16, 1, 256), CUDA events per "
        f"call: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"index_copy_ {row['library_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.6f} ms (bytes)")
    out.update(cow_timing(torch, dev))
    return out


def host_us(torch, fn, n=200):
    """Host microseconds to issue one call of ``fn``: the median over ``n``
    calls in a row, the card left to drain after them."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * sorted(ts)[n // 2]


def cow_timing(torch, dev):
    """One copy-on-write over gemma-2b's whole cache at batch 4 (18 layers,
    17 pages), fp and int8 pages: the engine's own ``_copy_page`` (in a
    parent tree timed by ``--timing-only --src``, whatever that tree's
    engine does), its launches, device ms (CUDA events) and host us per
    COW, beside the bound (each pool's page read and written once in every
    layer), the plain version (``ref.copy_page`` on each pool) and
    ``index_copy_`` on each pool (one call a pool, timed together)."""
    from types import SimpleNamespace
    from repro_torch.kernels.paged_attention import kernel, ref
    from repro_torch.serving import PagedServingEngine
    out = {}
    dst = torch.tensor([7], device=dev)
    for name, pools in gemma_cache_sets(torch, dev, 18, 17, 10).items():
        eng = SimpleNamespace(cache=dict(zip(("k", "v", "k_scale",
                                              "v_scale"), pools)))

        def cow():
            PagedServingEngine._copy_page(eng, 3, 7)

        n0 = kernel.copy_launches
        cow()
        launches = kernel.copy_launches - n0
        nbytes = sum(2 * p[:, 0].numel() * p.element_size() for p in pools)
        tag = f"copy per COW {name}"
        row = dict(ms=card_ms(torch, cow, label=tag),
                   plain_ms=card_ms(torch, lambda: [ref.copy_page(p, 3, 7)
                                                    for p in pools],
                                    label=tag),
                   library_ms=card_ms(torch, lambda: [
                       p.index_copy_(1, dst, p[:, 3:4]) for p in pools],
                       label=tag),
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                   launches_per_cow=launches, host_us=host_us(torch, cow),
                   pools=len(pools), bytes=nbytes)
        out[tag] = row
        log(f"[time] copy-on-write over gemma-2b's {name} cache "
            f"({len(pools)} pools, {nbytes} bytes moved), the engine's "
            f"_copy_page: {launches} launches, kernel {row['ms']:.4f} ms, "
            f"host {row['host_us']:.1f} us a COW, plain "
            f"{row['plain_ms']:.4f} ms, index_copy_ on each pool "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
            f"(bytes)")
    return out


# ---------------------------------------------------------------------------
# phase 10: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_inputs(torch, dev, dtype, B, S, H, Hkv, D, seed=0):
    """q, k, v, do in the kernels' flat layout, drawn on the CPU."""
    g = torch.Generator().manual_seed(seed)

    def mk(rows):
        return torch.randn(rows, S, D, generator=g).to(dev, dtype)

    return mk(B * H), mk(B * Hkv), mk(B * Hkv), mk(B * H)


def row_err(torch, got, want):
    """The worst row's ||got - want|| / ||want||, in fp32, over the last
    axis: a row is one query's o or dq, or one key's dk or dv, so a wrong
    late row (small |o| in a long causal band) counts as much as the
    first.  A row whose ||want|| is below a tenth of the median row's is
    held to that tenth instead: dq of a query that sees one key is a
    difference of two equal sums, zero up to rounding."""
    err = torch.linalg.vector_norm(got.float() - want.float(), dim=-1)
    norm = torch.linalg.vector_norm(want.float(), dim=-1)
    return (err / torch.clamp(norm, min=0.1 * norm.median())).max().item()


def tile_dropped(torch, Sq, Sk, device, causal, window, middle=False,
                 tile=64):
    """(Sq, Sk) True where a known-wrong kernel skips the pair: the last
    query tile loses one 64-key tile of its band, the last (the diagonal
    under the causal mask) or the middle one (at S 4096, 64 of about 4064
    keys)."""
    t0 = tile * ((Sq - 1) // tile)
    last = t0 // tile if causal else (Sk - 1) // tile
    first = max(0, t0 - window + 1) // tile if window > 0 else 0
    k0 = tile * ((first + last) // 2 if middle else last)
    qi = torch.arange(Sq, device=device)[:, None]
    kj = torch.arange(Sk, device=device)[None, :]
    return (qi >= t0) & (kj >= k0) & (kj < k0 + tile)


def flash_variant(torch, q, k, v, do, lse, dsum, *, n_q_heads, causal,
                  window, softcap, softcap_factor=True, drop=None):
    """A known-wrong kernel as dense plain algebra: (o, dq, dk, dv per KV
    head).  ``softcap_factor=False`` leaves the backward's (1 - tanh^2)
    out; ``drop`` ((Sq, Sk) bool) are pairs it skips, in the forward
    (which then normalises over what is left) and in the backward (which
    takes the given lse and dsum)."""
    from repro_torch.kernels.flash_attention import ref
    BH, Sq, D = q.shape
    rows = ref.kv_rows(BH, n_q_heads, k.shape[0], q.device)
    kf, vf = k.float()[rows], v.float()[rows]
    qf, dof = q.float(), do.float()
    s = torch.matmul(qf * D ** -0.5, kf.mT)
    if softcap > 0:
        t = torch.tanh(s / softcap)
        s = t * softcap
    mask = ref._mask(Sq, k.shape[1], causal, window, q.device)
    if drop is not None:
        mask = mask & ~drop
    o = torch.matmul(torch.softmax(torch.where(mask, s, ref.NEG_INF), -1)
                     .to(v.dtype).float(), vf).to(q.dtype)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    del s
    ds = p * (torch.matmul(dof, vf.mT) - dsum[..., None])
    if softcap > 0 and softcap_factor:
        ds = ds * (1.0 - t * t)
    dq = torch.matmul(ds, kf) * D ** -0.5
    dk = torch.matmul(ds.mT, qf) * D ** -0.5
    dv = torch.matmul(p.mT, dof)
    return (o, dq, ref.group_sum(dk, n_q_heads, k.shape[0]),
            ref.group_sum(dv, n_q_heads, k.shape[0]))


# phase 10's cases: (label, B, S, H, Hkv, D, causal, window, softcap); the
# softcap case scales q by 4, so scores reach the cap's curved part and the
# backward's (1 - tanh^2) factor matters
FLASH_CASES = [("granite (a)", 8, 128, 32, 8, 64, True, 0, 0.0),
               ("granite (b)", 1, 4096, 32, 8, 64, True, 0, 0.0),
               ("gemma MQA", 1, 256, 8, 1, 256, True, 0, 0.0),
               ("D 128 S 200", 1, 200, 4, 2, 128, True, 0, 0.0),
               ("window 32", 2, 200, 32, 8, 64, True, 32, 0.0),
               ("softcap 30", 2, 200, 32, 8, 64, True, 0, 30.0),
               ("non-causal", 2, 200, 32, 8, 64, False, 0, 0.0),
               ("launcher D 40", 8, 128, 4, 2, 40, True, 0, 0.0),
               # the bf16 tiling's edges: one row past a 64-row tile under
               # window and softcap; 127 rows of D 20 (8-byte copies); an
               # odd D (plain loads, no cp.async)
               ("S 65 window 32 softcap 30", 1, 65, 32, 8, 64, True, 32,
                30.0),
               ("D 20 S 127 non-causal", 2, 127, 4, 2, 20, False, 0, 0.0),
               ("D 33", 1, 96, 4, 1, 33, True, 0, 0.0),
               # the families' training shapes: hymba-1.5b's 25 query heads
               # over 5 kv heads past its 1024-token window and on a global
               # layer; whisper-small's encoder over 1500 frames (no tile
               # divides it, no mask) and its decoder
               ("hymba window 1024", 1, 2048, 25, 5, 64, True, 1024, 0.0),
               ("hymba global", 1, 2048, 25, 5, 64, True, 0, 0.0),
               ("whisper encoder", 4, 1500, 12, 12, 64, False, 0, 0.0),
               ("whisper decoder", 4, 448, 12, 12, 64, True, 0, 0.0)]
# cases the main paths run in bf16 alone
FLASH_BF16_ONLY = ("granite (b)", "hymba window 1024", "hymba global",
                   "whisper encoder")


def phase_flash_vs_plain(torch, dev):
    """The forward (with and without lse), dq and dk/dv kernels against
    their plain versions on the card, fp32 and bf16, row by row.
    Returns the worst max |kernel - plain| of each: {"fwd", "fwd_lse",
    "bwd"}."""
    from repro_torch.kernels.flash_attention import kernel, ref
    worst = {"fwd": 0.0, "fwd_lse": 0.0, "bwd": 0.0}
    worst_row = dict(worst)
    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[str(dtype).split(".")[-1]]
        for label, B, S, H, Hkv, D, causal, window, softcap in FLASH_CASES:
            if label in FLASH_BF16_ONLY and dtype == torch.float32:
                continue
            name = f"flash {label} {str(dtype).split('.')[-1]}"
            q, k, v, do = flash_inputs(torch, dev, dtype, B, S, H, Hkv, D)
            if softcap > 0:
                q = q * 4
            opts = dict(n_q_heads=H, causal=causal, window=window,
                        softcap=softcap)
            flipped = dict(opts, causal=not causal)
            o = kernel.flash_fwd(q, k, v, **opts)
            o2, lse = kernel.flash_fwd(q, k, v, with_lse=True, **opts)
            po, plse = ref.flash_fwd(q, k, v, with_lse=True, **opts)
            wrong_o = {"causal mask flipped": ref.flash_fwd(q, k, v,
                                                            **flipped)}
            unwindowed = dict(opts, window=0)
            if window > 0:
                wrong_o["window off"] = ref.flash_fwd(q, k, v, **unwindowed)
            dsum = (do.float() * po.float()).sum(-1)
            dropped = {w: flash_variant(
                torch, q, k, v, do, plse, dsum, **opts,
                drop=tile_dropped(torch, S, S, q.device, causal, window,
                                  middle=w.startswith("mid")))
                for w in ("last tile dropped", "mid-band tile dropped")}
            torch.cuda.synchronize()
            for key, got in (("fwd", o), ("fwd_lse", o2)):
                err = row_err(torch, got, po)
                judge(f"{name} {key}", err, tol,
                      {**{w: row_err(torch, x, po)
                          for w, x in wrong_o.items()},
                       **{w: row_err(torch, x[0], po)
                          for w, x in dropped.items()}},
                      what=ROW_ERR)
                worst[key] = max(worst[key], (got.float() - po.float())
                                 .abs().max().item())
                worst_row[key] = max(worst_row[key], err)
            lse_err = ((lse - plse).abs().max() / plse.abs().max()).item()
            if not lse_err <= LSE_TOL:
                raise AssertionError(f"{name}: lse off by {lse_err:.3e}")
            got = kernel.flash_bwd(q, k, v, do, plse, dsum, **opts)
            dq, dk_h, dv_h = ref.flash_bwd(q, k, v, do, plse, dsum, **opts)
            want = (dq, ref.group_sum(dk_h, H, k.shape[0]),
                    ref.group_sum(dv_h, H, k.shape[0]))
            wq, wk, wv = ref.flash_bwd(q, k, v, do, plse, dsum, **flipped)
            wrong = {"causal mask flipped": (
                wq, ref.group_sum(wk, H, k.shape[0]),
                ref.group_sum(wv, H, k.shape[0])),
                **{w: x[1:] for w, x in dropped.items()}}
            if window > 0:
                uq, uk, uv = ref.flash_bwd(q, k, v, do, plse, dsum,
                                           **unwindowed)
                wrong["window off"] = (uq, ref.group_sum(uk, H, k.shape[0]),
                                       ref.group_sum(uv, H, k.shape[0]))
            if softcap > 0:
                wrong["no softcap factor"] = flash_variant(
                    torch, q, k, v, do, plse, dsum, **opts,
                    softcap_factor=False)[1:]
            if H > Hkv:       # dk and dv of one query head per KV head
                heads = [x.reshape(B, Hkv, H // Hkv, S, D)[:, :, 0].reshape(
                    B * Hkv, S, D) for x in (dk_h, dv_h)]
                wrong["dk, dv not group-summed"] = (wq, *heads)
            torch.cuda.synchronize()
            for i, part in enumerate(("dq", "dk", "dv")):
                readings = {w: row_err(torch, x[i], want[i])
                            for w, x in wrong.items()
                            if not (part == "dq" and w.startswith("dk"))
                            and not (part == "dv" and w.startswith("no "))}
                err = row_err(torch, got[i], want[i])
                judge(f"{name} {part}", err, tol, readings, what=ROW_ERR)
                worst["bwd"] = max(worst["bwd"], (got[i].float()
                                                  - want[i].float())
                                   .abs().max().item())
                worst_row["bwd"] = max(worst_row["bwd"], err)
            del dropped, wrong
            again = kernel.flash_bwd(q, k, v, do, plse, dsum, **opts)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name}: the backward is not "
                                     f"deterministic")
    log(f"[flash] every case within tolerance; worst row's "
        f"||kernel - plain|| / ||plain||: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst_row.items())
        + "; max |kernel - plain|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


# ---------------------------------------------------------------------------
# phase 11: granite-3-2b trains at full width on the flash kernels
# ---------------------------------------------------------------------------

def flash_counts():
    from repro_torch.kernels.flash_attention import kernel
    return {k: getattr(kernel, f"{k}_launches")
            for k in ("fwd", "fwd_lse", "dq", "dkv")}


def zero_flash_counts():
    from repro_torch.kernels.flash_attention import kernel
    for k in ("fwd", "fwd_lse", "dq", "dkv"):
        setattr(kernel, f"{k}_launches", 0)


def leaf_errs(torch, a, b, part=None):
    """Per-leaf ||a - b|| / ||b|| of two gradient trees: the worst and
    its leaf (of the leaves under a ``part`` node, such as ``attn``, if
    given)."""
    from repro_torch.core.tree import get_path, leaf_paths
    worst, at = 0.0, ""
    for path in leaf_paths(b):
        if part is not None and part not in path:
            continue
        x, y = get_path(a, path).float(), get_path(b, path).float()
        e = (torch.linalg.vector_norm(x - y)
             / torch.linalg.vector_norm(y)).item()
        if e > worst:
            worst, at = e, "/".join(path)
    return worst, at


def train_breakdown(torch, cfg, step, st, batch):
    """Wall and device time of one train step under ``torch.profiler``,
    by kernel family, and of its AdamW update alone."""
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.train.steps import loss_and_grads
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(st, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rows = profiled(torch, lambda: step(st, batch), 1)
    busy = sum(r[0] for r in rows) / 1e3
    flash = sum(r[0] for r in rows if "flash_" in r[2]) / 1e3
    blas = sum(r[0] for r in rows
               if any(s in r[2] for s in BLAS_KERNELS)) / 1e3
    _, _, grads = loss_and_grads(cfg, st.params, {
        k: v.to(st.step.device) for k, v in batch.items()})
    adamw = device_ms(torch, lambda: adamw_update(
        grads, st.opt_state, st.params, 1e-4, AdamWConfig()), reps=2,
        warmup=1)
    del grads
    log(f"[train] step breakdown: wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}; flash kernels "
        f"{flash:.1f} ms, cuBLAS {blas:.1f} ms, AdamW (alone) {adamw:.1f} "
        f"ms")
    for us, n, key in rows[:8]:
        log(f"[train]   {us / 1e3:.3f} ms x{n}  {key[:90]}")
    return dict(wall_ms=wall, busy_ms=busy, flash_ms=flash, blas_ms=blas,
                adamw_ms=adamw)


def phase_train_full_width(torch, dev):
    """granite-3-2b at full width on the flash path: the first step's loss
    and grads against the plain-attention path, then (a) 5 steps at batch
    8, seq 128 and (b) one step at batch 1, seq 4096, with the flash
    launches the code implies.  Returns the launch counts of the run."""
    import dataclasses
    from repro_torch.config import ShapeConfig, get_config
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.steps import (TrainState, loss_and_grads,
                                         make_train_step)
    base = get_config("granite-3-2b")
    cfg = dataclasses.replace(base, use_pallas_attention=True,
                              scan_layers=False)
    plain = dataclasses.replace(base, scan_layers=False)
    L = cfg.n_layers
    torch.cuda.empty_cache()          # blocks cached by earlier phases
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device=dev,
                           param_dtype=torch.float32)
    torch.cuda.synchronize()
    log(f"[train] granite-3-2b: {M.count_params(cfg) / 1e9:.3f} B fp32 "
        f"master parameters in {time.perf_counter() - t0:.1f} s; compute "
        f"{cfg.dtype}, remat {cfg.remat}, {L} layers, head_dim "
        f"{cfg.head_dim}")
    batch_a = make_batch_fn(cfg, ShapeConfig("a", 128, 8, "train"),
                            seed=0)
    b0 = {k: v.to(dev) for k, v in batch_a(0).items()}

    # the first step's loss and grads: flash against plain attention, both
    # bf16, beside the plain path's own distance from fp32 and a wrong
    # attention (a 32-token window in every layer)
    zero_flash_counts()
    loss_f, _, g_f = loss_and_grads(cfg, params, b0)
    torch.cuda.synchronize()
    once = flash_counts()
    loss_p, _, g_p = loss_and_grads(plain, params, b0)
    err, at = leaf_errs(torch, g_f, g_p)
    del g_f
    loss_32, _, g_32 = loss_and_grads(
        dataclasses.replace(plain, dtype="float32"), params, b0)
    fp32_err, fp32_at = leaf_errs(torch, g_p, g_32)
    del g_32
    loss_w, _, g_w = loss_and_grads(
        dataclasses.replace(cfg, sliding_window=32), params, b0)
    wrong_err, _ = leaf_errs(torch, g_w, g_p)
    del g_w, g_p
    lf, lp, l32, lw = (x.item() for x in (loss_f, loss_p, loss_32, loss_w))
    log(f"[train] first step loss: flash {lf:.6f}, plain {lp:.6f} "
        f"(|diff| {abs(lf - lp):.3e}, tol {LOSS_RTOL:g} x loss); plain fp32 "
        f"{l32:.6f}; a 32-token window {lw:.6f}")
    if not (math.isfinite(lf) and abs(lf - lp) <= LOSS_RTOL * abs(lp)):
        raise AssertionError("full width: the flash path's loss differs "
                             "from plain attention's")
    judge("granite-3-2b grads", err, GRAD_RATIO * fp32_err,
          {"a 32-token window": wrong_err},
          extra=f"; worst at {at}; tolerance {GRAD_RATIO:g} x the plain "
                f"bf16 grads' distance from fp32 ({fp32_err:.3e} at "
                f"{fp32_at})",
          what="worst leaf's ||flash - plain|| / ||plain||")
    want = {"fwd": 0, "fwd_lse": 2 * L, "dq": L, "dkv": L}
    if once != want:
        raise AssertionError(f"one loss_and_grads launched {once}, the code "
                             f"implies {want} (remat full: forward + "
                             f"recompute)")

    st = TrainState(params, adamw_init(params, AdamWConfig()),
                    torch.zeros((), dtype=torch.int32, device=dev))
    del params
    step = make_train_step(cfg, base_lr=3e-4, warmup=2, total_steps=10)
    st, _ = step(st, batch_a(0))          # warm: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts()
    t0 = time.perf_counter()
    losses = []
    for i in range(1, 6):
        st, m = step(st, batch_a(i))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got_a = flash_counts()
    losses = [x.item() for x in losses]
    log(f"[train] (a) 5 steps at batch 8, seq 128: {wall / 5 * 1e3:.1f} ms "
        f"per step, {5 * 8 * 128 / wall:.0f} tokens/s; losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
        f"GiB; flash launches {got_a}")
    want_a = {k: 5 * v for k, v in want.items()}
    if got_a != want_a or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"(a): launches {got_a}, the code implies "
                             f"{want_a}; losses {losses}")
    breakdown = train_breakdown(torch, cfg, step, st, batch_a(6))

    batch_b = make_batch_fn(cfg, ShapeConfig("b", 4096, 1, "train"),
                            seed=1)(0)
    zero_flash_counts()
    t0 = time.perf_counter()
    st, m = step(st, batch_b)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    got_b = flash_counts()
    loss_b = m["loss"].item()
    # the same batch forward only: the flash path without lse (row 4)
    # against plain attention
    bb = {k: v.to(dev) for k, v in batch_b.items()}
    with torch.no_grad():
        ev_f = M.loss_fn(cfg, st.params, bb)[0].item()
        got_eval = flash_counts()
        ev_p = M.loss_fn(plain, st.params, bb)[0].item()
    log(f"[train] (b) 1 step at batch 1, seq 4096: {wall_b * 1e3:.1f} ms, "
        f"loss {loss_b:.4f}; flash launches {got_b}; forward-only loss "
        f"after it: flash {ev_f:.6f}, plain {ev_p:.6f}; launches then "
        f"{got_eval}")
    if got_b != want or not math.isfinite(loss_b):
        raise AssertionError(f"(b): launches {got_b}, the code implies "
                             f"{want}; loss {loss_b}")
    if got_eval["fwd"] != L or abs(ev_f - ev_p) > LOSS_RTOL * abs(ev_p):
        raise AssertionError(f"(b) forward only: {got_eval}, loss flash "
                             f"{ev_f} against plain {ev_p}")
    del bb
    log("[train] (b) breakdown:")
    breakdown_b = train_breakdown(torch, cfg, step, st, batch_b)
    del st
    torch.cuda.empty_cache()
    total = {k: got_a[k] + got_eval[k] for k in got_a}
    return dict(launches=total, breakdown=breakdown, breakdown_b=breakdown_b,
                wall_a_ms=wall / 5 * 1e3, wall_b_ms=wall_b * 1e3)


# ---------------------------------------------------------------------------
# phase 11b: the launcher through the five verbs on the card
# ---------------------------------------------------------------------------

def phase_train_launcher(torch, dev, steps=200):
    """launch.train at examples/train_lm.py's reduced config with the
    flash path and a preemption at the half, against the same run
    uninterrupted: the loss falls, the attempts show the resume, and the
    final parameters are bit-equal."""
    import contextlib
    import io
    import tempfile
    from repro_torch.core import tree
    from repro_torch.launch import train as train_driver
    argv = ["--reduced", "--d-model", "320", "--n-layers", "6", "--vocab",
            "2048", "--arch", "granite-3-2b", "--steps", str(steps),
            "--batch", "8", "--seq", "128", "--lr", "3e-3",
            "--checkpoint-every", "50", "--pallas-attention", "--device",
            dev.type]
    quiet = io.StringIO()       # the driver's own JSON report
    with tempfile.TemporaryDirectory(dir=HERE) as ws, \
            contextlib.redirect_stdout(quiet):
        zero_flash_counts()
        rep = train_driver.main(argv + ["--preempt-at", str(steps // 2),
                                        "--workspace", f"{ws}/a"])
        launches = flash_counts()
        ref = train_driver.main(argv + ["--workspace", f"{ws}/b"])
    same = all(torch.equal(a, b) for a, b in zip(
        tree.flatten(rep["state"])[0], tree.flatten(ref["state"])[0]))
    resumed = [a["resumed_from"] for a in rep["attempts"]]
    log(f"[launcher] {rep['params']} parameters on {rep['device']}: loss "
        f"{rep['first_loss']:.3f} -> {rep['last_loss']:.3f} (floor "
        f"{rep['entropy_floor']:.3f}) in {rep['wall_s']} s; attempts "
        f"resumed from {resumed}; flash launches {launches}; final params "
        f"bit-equal to an uninterrupted run: {same}")
    if not rep["first_loss"] - rep["last_loss"] > 0.5:
        raise AssertionError("launcher: the loss did not fall")
    if resumed != [None, steps // 2] or not same:
        raise AssertionError("launcher: the preempted run did not resume "
                             "to the uninterrupted run's parameters")
    if launches["fwd_lse"] == 0 or launches["dq"] != launches["dkv"]:
        raise AssertionError(f"launcher: flash launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 12: flash-attention timing
# ---------------------------------------------------------------------------

def flash_bound(torch, dtype, B, S, H, Hkv, D, *, backward, lse=True):
    """Least time on an H100 SXM: every input byte read once and every
    output written once (forward: q, k, v in, o and, with ``lse``, lse
    out; backward: q,
    k, v, do, lse, dsum in, dq, dk, dv out), or the operations the visible
    (query, key) pairs need (4 D each forward, 10 D backward: S and dP,
    then dQ, dK, dV) at the input type's peak, whichever is larger."""
    item = torch.empty((), dtype=dtype).element_size()
    pairs = B * H * S * (S + 1) // 2                 # causal
    q_bytes, kv_bytes, row_bytes = B * H * S * D * item, \
        B * Hkv * S * D * item, B * H * S * 4
    if backward:
        nbytes = 3 * q_bytes + 4 * kv_bytes + 2 * row_bytes
        ops = 10 * D * pairs
    else:
        nbytes = 2 * q_bytes + 2 * kv_bytes + (row_bytes if lse else 0)
        ops = 4 * D * pairs
    dt = str(dtype).split(".")[-1]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def event_ms(torch, fn, reps, warmup=2):
    """Device milliseconds per call: (median, least, most) over ``reps``
    calls, each between CUDA events of its own, and whether the queue
    held.  A sleep kernel queued first keeps the card busy while the host
    issues the calls, so the card runs them back to back and a delay of
    the host falls between two calls, not inside one; the queue held if
    the sleep was still running when the host had issued the last call."""
    for _ in range(warmup):
        fn()
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
             for _ in range(reps)]
    slept = torch.cuda.Event()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    slept.record()
    for start, stop in marks:
        start.record()
        fn()
        stop.record()
    held = not slept.query()
    torch.cuda.synchronize()
    ts = sorted(start.elapsed_time(stop) for start, stop in marks)
    return ts[len(ts) // 2], ts[0], ts[-1], held


def flash_build_report():
    """Each flash instantiation's registers, spills and static shared
    memory (the ptxas log), the dynamic shared memory its launch asks
    for, and its HMMA (tensor-core) and LDGSTS (cp.async) instructions
    (``cuobjdump -sass``).  Raises if a bf16 kernel has no HMMA or no
    LDGSTS, if an fp32 one has HMMA, or if a bf16 kernel spills at D 64
    (granite-3-2b's head dim, the main path's)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel
    rep = _build.ptxas_report("flash_attention")
    sass = _build.sass_counts("flash_attention")
    names = _build.demangle(sorted(rep))
    bad = []
    for f in sorted(rep, key=lambda f: names[f]):
        r, c, name = rep[f], sass.get(f, {}), names[f]
        bf16 = "_mma" in f
        kind = ("dkv" if "dkv" in f else "dq" if "dq" in f else "fwd")
        d = next((dm for dm in (16, 32, 64, 128, 256)
                  if f"Li{dm}E" in f), None)   # the padded head dim
        smem = (kernel.smem_bytes(kind, torch.bfloat16 if bf16
                                  else torch.float32, d) if d else None)
        log(f"[build] {name[:72]}: {r['registers']} registers, spill "
            f"stores {r['spill_stores']} B, loads {r['spill_loads']} B, "
            f"static smem {r['smem']} B, dynamic smem {smem} B; SASS HMMA "
            f"{c.get('HMMA')}, LDGSTS {c.get('LDGSTS')}")
        if bf16 and not (c.get("HMMA") and c.get("LDGSTS")):
            bad.append(f"{name}: a bf16 kernel without HMMA or LDGSTS")
        if not bf16 and c.get("HMMA"):
            bad.append(f"{name}: an fp32 kernel with HMMA")
        if bf16 and d == 64 and (r["spill_stores"] or r["spill_loads"]):
            bad.append(f"{name}: spills at D 64")
    if bad:
        raise AssertionError("; ".join(bad))


def phase_flash_timing(torch, dev):
    """Device time per call of the three flash kernels at granite-3-2b's
    full-width training shapes, bf16 causal, beside the bound, the plain
    versions and SDPA (forward, and backward alone).  The median of CUDA
    events around each call (``event_ms``), with ``torch.profiler``'s
    device sum beside it: at S 4096 the profiler reported no device time
    for the forward kernel and for SDPA's forward, and part of the
    backward's."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ref
    flash_build_report()
    out = {}
    for label, B, S in (("(a)", 8, 128), ("(b)", 1, 4096)):
        H, Hkv, D, dt = 32, 8, 64, torch.bfloat16
        q, k, v, do = flash_inputs(torch, dev, dt, B, S, H, Hkv, D)
        opts = dict(n_q_heads=H, causal=True)
        o, lse = kernel.flash_fwd(q, k, v, with_lse=True, **opts)
        dsum = (do.float() * o.float()).sum(-1)
        reps = 30 if S <= 512 else 9
        # SDPA in its (B, H, S, D) layout, GQA without repeat; the layout
        # change happens outside the timed calls
        qs, ks, vs, dos = (x.reshape(B, -1, S, D) for x in (q, k, v, do))
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (qs, ks, vs))
        og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                            enable_gqa=True)
        calls = {
            "fwd": lambda: kernel.flash_fwd(q, k, v, **opts),
            "fwd_lse": lambda: kernel.flash_fwd(q, k, v, with_lse=True,
                                                **opts),
            "bwd": lambda: kernel.flash_bwd(q, k, v, do, lse, dsum, **opts),
            "plain fwd": lambda: ref.flash_fwd(q, k, v, **opts),
            "plain fwd_lse": lambda: ref.flash_fwd(q, k, v, with_lse=True,
                                                   **opts),
            "plain bwd": lambda: ref.flash_bwd(q, k, v, do, lse, dsum,
                                               **opts),
            "sdpa fwd": lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True),
            "sdpa bwd": lambda: torch.autograd.grad(
                og, (qg, kg, vg), dos, retain_graph=True)}
        ev, prof = {}, {}
        for name, fn in calls.items():
            n = 5 if name.startswith("plain") else reps
            for _ in range(3):
                med, lo, hi, held = event_ms(torch, fn, n)
                if held:
                    break
                log(f"[time] flash {label} {name}: the card drained its "
                    f"queue before the host issued the last call; again")
            else:
                raise AssertionError(f"flash timing {label} {name}: the "
                                     f"queue never held")
            ev[name] = med
            prof[name] = device_ms(torch, fn, reps=n, warmup=1)
            log(f"[time] flash {label} {name}: CUDA events per call, "
                f"median {med:.4f} ms of {n} (least {lo:.4f}, most "
                f"{hi:.4f}); the profiler's device sum per call "
                f"{prof[name]:.4f} ms")
        t = {k: ev[k] for k in ("fwd", "fwd_lse", "bwd")}
        plain = {k: ev[f"plain {k}"] for k in t}
        sdpa_fwd, sdpa_bwd = ev["sdpa fwd"], ev["sdpa bwd"]
        for key in t:
            bwd = key == "bwd"
            b_ms, b_by = flash_bound(torch, dt, B, S, H, Hkv, D,
                                     backward=bwd, lse=key != "fwd")
            out[(label, key)] = dict(
                ms=t[key], plain_ms=plain[key], bound_ms=b_ms, bound_by=b_by,
                library_ms=sdpa_bwd if bwd else sdpa_fwd)
            log(f"[time] flash {key} {label} B {B} S {S} H {H} Hkv {Hkv} "
                f"D {D} bf16 causal, device time per call (CUDA events): "
                f"kernel "
                f"{t[key]:.4f} ms, plain {plain[key]:.4f} ms, sdpa "
                f"{'backward' if bwd else 'forward'} "
                f"{out[(label, key)]['library_ms']:.4f} ms, bound "
                f"{b_ms:.6f} ms ({b_by})")
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
                                   (500, 300, 37, -4.0, 124.0),
                                   (500, 300, 3, -4.0, 124.0),
                                   (777, 130, 5, 45.0, 20.0)):
        il_, w_, t_ = recovery_case(E_, m_, P_)
        cases.append((f"E {E_} m {m_} P {P_} att {att:g} limit {limit:g}",
                      il_, w_, t_, att, limit))
    return cases


def tile_columns_dropped(torch, sq, tile, n=8):
    """What a wide kernel that never computed the last ``n`` live columns
    of each tile of ``tile`` individuals would return: 0 in those rows."""
    P = sq.shape[0]
    p = torch.arange(P, device=sq.device)
    live_end = torch.clamp((p // tile + 1) * tile, max=P)
    return torch.where(p >= live_end - n, torch.zeros_like(sq), sq)


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
        route = kernel.fitness_plan(E, il.shape[1], w.shape[0]).route
        if route == "wide":
            wrong["last 8 columns of each P tile dropped"] = rel(
                tile_columns_dropped(torch, want, kernel.BLOCK_INDIVIDUALS))
        finite = bool(torch.isfinite(got).all())
        # the narrow kernel's rows against the wide kernel's, bit for bit:
        # the same rows inside a population too wide for the narrow one (a
        # CPU rehearsal runs the plain version, which is not row-local)
        same = ""
        if route == "narrow" and dev.type == "cuda":
            big = torch.cat([w, w.flip(0).repeat(kernel.P_NARROW, 1)])
            wide = kernel.fitness_sq(il, big, target, att, limit)[:len(w)]
            sync(torch, dev)
            if not torch.equal(got, wide):
                raise AssertionError(f"narrow fitness kernel differs from "
                                     f"the wide one: {name}")
            same = ", its rows bit-equal to the wide kernel's"
        log(f"[fitness] {name} ({route}): max|kernel - plain|/|plain| = "
            f"{err:.3e} (tol {FIT_RTOL:g}; a wrong kernel: " + ", ".join(
                f"{k} {v:.3e}" for k, v in wrong.items())
            + f"), finite {finite}{same}")
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
    """Wall and device busy time and launches on the card per GA
    generation at the paper's scale, and the kernels that take the most
    device time.  Returns {wall_ms, busy_ms, launches}."""
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
    launches = sum(r[1] for r in rows) / gens
    log(f"[catopt] generation (P {cfg.pop_size}, polish {cfg.polish_k} x "
        f"{cfg.polish_steps}): wall {wall:.3f} ms, device busy {busy:.3f} "
        f"ms, idle share {1 - busy / wall:.3f}, {launches:g} launches on "
        f"the card")
    for us, n, key in rows[:10]:
        log(f"[catopt]   {us / gens / 1e3:.4f} ms x{n // gens}  {key[:90]}")
    return dict(wall_ms=wall, busy_ms=busy, launches=launches)


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


def kernel_route(kernel, il, w):
    """Which fitness kernel a call takes: "narrow" or "wide" (a tree
    without the narrow kernel: "wide")."""
    if not hasattr(kernel, "fitness_plan"):
        return "wide"
    return kernel.fitness_plan(il.shape[0], il.shape[1], w.shape[0]).route


def build_report(name):
    """Each instantiation's registers, spills and static shared memory in
    kernel source ``name``'s ptxas log."""
    from repro_torch.kernels import _build
    rep = _build.ptxas_report(name)
    names = _build.demangle(sorted(rep))
    for f in sorted(rep, key=lambda f: names[f]):
        r = rep[f]
        log(f"[build] {name}: {names[f][:90]}: {r['registers']} registers, "
            f"spill stores {r['spill_stores']} B, loads {r['spill_loads']} "
            f"B, stack {r['stack']} B, static smem {r['smem']} B")


def phase_fitness_timing(torch, dev, problem):
    from repro_torch.kernels.recovery import kernel, ref
    build_report("fitness")
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

        tag = f"fitness {label}"
        ms = card_ms(torch, lambda: kernel.fitness_sq(il, w, target, att,
                                                      limit), label=tag)
        plain_ms = card_ms(torch, lambda: ref.fitness_sq(il, w, target, att,
                                                         limit), label=tag)
        library_ms = card_ms(torch, library, label=tag)
        bound_ms, bound_by = fitness_bound(il.shape[0], il.shape[1], P)
        out[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        log(f"[time] fitness {label} E {il.shape[0]} m {il.shape[1]} P {P} "
            f"fp32 ({kernel_route(kernel, il, w)}), CUDA events per call: "
            f"kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, matmul + epilogue {library_ms:.4f} ms, "
            f"bound {bound_ms:.6f} ms ({bound_by})")
    return out


# ---------------------------------------------------------------------------
# phases 13 to 15: rwkv6-1.6b and the wkv kernel
# ---------------------------------------------------------------------------

def rwkv_model(torch, dev):
    """rwkv6-1.6b at full width (bf16, seed 0, ``use_pallas_wkv``) and B 1 x
    S ``RWKV_SEQ`` uniform random tokens."""
    import dataclasses
    from repro_torch.config import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), use_pallas_wkv=True)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device=dev)
    sync(torch, dev)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (1, RWKV_SEQ), generator=g).to(dev)
    log(f"[rwkv] {cfg.name}: {M.count_params(cfg) / 1e9:.3f} B parameters "
        f"({cfg.dtype} matrices, fp32 norms, mu, decay and bonus) in "
        f"{time.perf_counter() - t0:.1f} s; {cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}")
    return cfg, params, toks


def layer0_inputs(torch, cfg, params, toks):
    """Layer 0's r, k, v (bf16) and w (fp32) on ``toks``, as the model
    computes them, and a bonus u drawn normal x 0.1: the model's own u is
    zero, which would hide a wrong bonus term."""
    from repro_torch.models import rwkv6
    from repro_torch.models.layers import apply_norm, embed_tokens
    from repro_torch.models.transformer import unstack
    lp = unstack(params["layers"], cfg.n_layers)[0]
    with torch.no_grad():
        x = apply_norm(lp["ln1"], embed_tokens(params["embed"], toks, cfg))
        r, k, v, w, _ = rwkv6.time_mix_inputs(lp["rwkv"]["tm"], x, cfg)
    g = torch.Generator().manual_seed(2)
    u = (torch.randn(cfg.n_heads, cfg.head_dim, generator=g) * 0.1).to(
        toks.device)
    return r, k, v, w, u


def wkv_head_u(torch, r, k, v, w, u, columns):
    """The block owning the last ``columns`` columns of every head took the
    next head's bonus u (a wrong head index in a column block)."""
    from repro_torch.kernels.wkv6 import ref
    out = ref.wkv(r, k, v, w, u)
    out[..., -columns:] = ref.wkv(r, k, v, w, u.roll(1, 0))[..., -columns:]
    return out


def wkv_dot_after_update(torch, r, k, v, w, u):
    """The dot r . S taken on the state after the token's update:
    r . (diag(w) S + k v^T) = (r * w) . S + (r . k) v, plus the bonus."""
    from repro_torch.kernels.wkv6 import ref
    rf, kf, vf = (t.float() for t in (r, k, v))
    return ref.wkv(rf * w.float(), k, v, w, torch.zeros_like(u)) + (
        (rf * kf).sum(-1, keepdim=True)
        + (rf * (u.float() * kf)).sum(-1, keepdim=True)) * vf


def wkv_wrong(torch, r, k, v, w, u, only=None):
    """Known-wrong kernels as plain algebra, each subtle at late tokens:
    {label: output}, or only the one labelled ``only``.  The bonus u
    dropped; the state reset at the middle 128-token chunk boundary (the
    TPU kernel's chunk); the decay skipped on one token 64 from the end;
    k v^T transposed in the update (the plain scan with k and v swapped,
    its bonus term put right); the last column block of each head with the
    next head's u; the dot taken on the state after the update."""
    from repro_torch.kernels.wkv6 import kernel, ref
    S, D = r.shape[1], r.shape[3]
    mid, late = 128 * (S // 128 // 2), S - 64

    def bonus(a):
        return (r.float() * (u.float() * a.float())).sum(-1, keepdim=True)

    def skipped():
        w_skip = w.clone()
        w_skip[:, late] = 1.0
        return ref.wkv(r, k, v, w_skip, u)

    readings = {
        "bonus u dropped": lambda: ref.wkv(r, k, v, w, torch.zeros_like(u)),
        f"state reset at token {mid}": lambda: torch.cat(
            [ref.wkv(r[:, :mid], k[:, :mid], v[:, :mid], w[:, :mid], u),
             ref.wkv(r[:, mid:], k[:, mid:], v[:, mid:], w[:, mid:], u)], 1),
        f"decay skipped at token {late}": skipped,
        "k v^T transposed": lambda: ref.wkv(r, v, k, w, u)
        - bonus(v) * k.float() + bonus(k) * v.float(),
        "last column block with the next head's u": lambda: wkv_head_u(
            torch, r, k, v, w, u, kernel.BLOCK_COLUMNS),
        "dot on the state after the update": lambda: wkv_dot_after_update(
            torch, r, k, v, w, u)}
    return {name: fn() for name, fn in readings.items()
            if only is None or name == only}


def phase_wkv_vs_plain(torch, dev, real):
    """The wkv kernel against its plain version on the card, row by row
    (a row: one token's output of one head), fp32 and bf16 r, k, v: the
    JAX test's four shapes; layer 0's real inputs at B 1 x S ``RWKV_SEQ``
    (w fp32, as the model gives it), with known-wrong readings beside the
    limit; w drawn near 1 at the same length, so the state carries across
    thousands of tokens.  Returns (worst max |kernel - plain|, worst row
    error)."""
    from repro_torch.kernels.wkv6 import kernel, ref
    worst_abs, worst_row = 0.0, 0.0

    def check(label, ins, want, wrong=None):
        nonlocal worst_abs, worst_row
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            x = [t.to(dtype) for t in ins[:3]] + list(ins[3:])
            got = kernel.wkv6(*x)
            sync(torch, dev)
            if got.dtype != dtype or got.shape != want.shape:
                raise AssertionError(f"wkv {label} {dt}: {got.dtype} "
                                     f"{tuple(got.shape)}")
            err = row_err(torch, got, want)
            mx = (got.float() - want).abs().max().item()
            worst_abs, worst_row = max(worst_abs, mx), max(worst_row, err)
            judge(f"wkv {label} {dt} (w {x[3].dtype})", err, WKV_TOL[dt],
                  {k: row_err(torch, o, want) for k, o in
                   (wrong or {}).items()}, f", max|kernel - plain| {mx:.3g}",
                  what=ROW_ERR)

    g = torch.Generator().manual_seed(3)
    for B, S, H, D in ((2, 64, 4, 16), (1, 96, 2, 32), (2, 128, 3, 64),
                       (1, 64, 1, 128)):
        r, k, v = (torch.randn(B, S, H, D, generator=g).to(dev)
                   for _ in range(3))
        w = torch.sigmoid(torch.randn(B, S, H, D, generator=g)).to(dev)
        u = (torch.randn(H, D, generator=g) * 0.1).to(dev)
        # the same bf16-representable values in both dtypes: one plain run
        r, k, v = (t.bfloat16().float() for t in (r, k, v))
        wrong = {"bonus u dropped": ref.wkv(r, k, v, w, torch.zeros_like(u)),
                 "dot on the state after the update": wkv_dot_after_update(
                     torch, r, k, v, w, u)}
        if H > 1:
            wrong["last column block with the next head's u"] = wkv_head_u(
                torch, r, k, v, w, u, kernel.BLOCK_COLUMNS)
        check(f"B {B} S {S} H {H} D {D}", (r, k, v, w, u),
              ref.wkv(r, k, v, w, u), wrong)
    r, k, v, w, u = real
    B, S, H, D = r.shape
    want = ref.wkv(r, k, v, w, u)
    check(f"layer 0 of rwkv6-1.6b B {B} S {S} H {H} D {D}",
          (r, k, v, w, u), want, wkv_wrong(torch, r, k, v, w, u))
    del want
    r, k, v = (torch.randn(B, S, H, D, generator=g).to(dev, torch.bfloat16)
               for _ in range(3))
    w = (0.999 + 0.0009 * torch.rand(B, S, H, D, generator=g)).to(dev)
    reset = f"state reset at token {128 * (S // 128 // 2)}"
    check(f"w in [0.999, 0.9999] B {B} S {S} H {H} D {D}",
          (r, k, v, w, u), ref.wkv(r, k, v, w, u),
          {reset: wkv_wrong(torch, r, k, v, w, u, only=reset)[reset]})
    return worst_abs, worst_row


def phase_rwkv_full_width(torch, dev, cfg, params, toks):
    """rwkv6-1.6b at full width: ``make_prefill_step`` at B 1 x S
    ``RWKV_SEQ`` with exactly n_layers wkv launches a call; the model on
    the kernel against the plain (exact scan) path and fp32 at S 2048;
    teacher-forced ``decode_step`` logits against the kernel forward; the
    state's bytes after a short and a long prompt; greedy serving through
    ``launch/serve.main --engine batch``; peak memory.  Returns the wkv
    launches of the prefill run."""
    import dataclasses
    from repro_torch.kernels.wkv6 import kernel
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import model as M
    from repro_torch.models.layers import logits_from_hidden
    from repro_torch.train.steps import make_decode_step, make_prefill_step
    L, d = cfg.n_layers, cfg.d_model
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    step = make_prefill_step(cfg)
    batch = {"tokens": toks}
    # -- the main path: a warm call and RWKV_STEPS timed ------------------
    kernel.launches = 0
    walls = []
    for _ in range(1 + RWKV_STEPS):
        t0 = time.perf_counter()
        last = step(params, batch)
        sync(torch, dev)
        walls.append(time.perf_counter() - t0)
    launches = kernel.launches
    if launches != L * len(walls):
        raise AssertionError(f"rwkv prefill: {launches} wkv launches for "
                             f"{len(walls)} calls, expected "
                             f"{L * len(walls)}")
    if last.shape != (1, 1, d) or not torch.isfinite(last).all():
        raise AssertionError(f"rwkv prefill: {tuple(last.shape)}, finite "
                             f"{bool(torch.isfinite(last).all())}")
    ms = sorted(walls[1:])[len(walls[1:]) // 2] * 1e3
    S = toks.shape[1]
    log(f"[rwkv] make_prefill_step B 1 x S {S}: {launches} wkv launches "
        f"in {len(walls)} calls ({L} a call); wall per call {ms:.1f} ms "
        f"(median of {RWKV_STEPS} after a warm call {walls[0] * 1e3:.1f} "
        f"ms), {S / ms * 1e3:.0f} tokens/s")
    if dev.type == "cuda":
        rows = profiled(torch, lambda: step(params, batch), 1)
        busy = sum(r[0] for r in rows) / 1e3
        wkv = sum(r[0] for r in rows if "wkv6" in r[2]) / 1e3
        blas = sum(r[0] for r in rows
                   if any(b in r[2].lower() for b in BLAS_KERNELS)) / 1e3
        log(f"[rwkv] prefill under torch.profiler: device busy {busy:.1f} "
            f"ms (idle share {1 - busy / ms:.3f} of the timed wall), wkv "
            f"kernel {wkv:.1f} ms, cuBLAS {blas:.1f} ms, the rest "
            f"{busy - wkv - blas:.1f} ms")
        for us, n, key in rows[:10]:
            log(f"[rwkv]   {us / 1e3:.3f} ms x{n}  {key[:90]}")
    # -- S 2048: kernel forward, plain path (prefill_cached: the exact scan,
    # carrying the state), fp32 plain ------------------------------------
    T = min(2048, S)
    short = toks[:, :T]
    with torch.no_grad():
        hk = M.forward(cfg, params, {"tokens": short})
        cache = M.init_cache(cfg, 1, T + 1, device=dev)
        hs, cache = M.prefill_cached(cfg, params, {"tokens": short}, cache)
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    use_pallas_wkv=False)
        p32 = tree_map(lambda t: t.float(), params)
        h32 = M.forward(cfg32, p32, {"tokens": short})
        del p32
    state_long = sum(t.numel() * t.element_size()
                     for t in cache["rwkv"].values())
    last_err = row_err(torch, hk[:, -1], hs[:, -1])
    worst = row_err(torch, hk, hs)
    plain32 = row_err(torch, hs, h32)
    kern32 = row_err(torch, hk, h32)
    log(f"[rwkv] S {T}, final hidden, {ROW_ERR}: kernel vs plain last row "
        f"{last_err:.3g}, worst row {worst:.3g}; kernel vs fp32 "
        f"{kern32:.3g}, plain bf16 vs fp32 {plain32:.3g} (limit "
        f"{TF_RATIO} x that: {TF_RATIO * plain32:.3g})")
    if not (worst <= TF_RATIO * plain32 and kern32 <= TF_RATIO * plain32):
        raise AssertionError("rwkv: the kernel path left the plain path by "
                             "more than bf16's own distance from fp32")
    # -- teacher-forced decode on the state of a P-token prompt -----------
    P, n = 64, 8
    decode = make_decode_step(cfg)
    cache = M.init_cache(cfg, 1, P + n, device=dev)
    with torch.no_grad():
        _, cache = M.prefill_cached(cfg, params, {"tokens": short[:, :P]},
                                    cache)
        state_short = sum(t.numel() * t.element_size()
                          for t in cache["rwkv"].values())
        dec = torch.cat([decode(params, cache, short[:, p:p + 1], p)[0]
                         for p in range(P, P + n)], 1).float()
        V = cfg.vocab
        fwd = logits_from_hidden(params, hk[:, P:P + n], cfg).float()
        ref16 = logits_from_hidden(params, hs[:, P:P + n], cfg).float()
        head32 = {"lm_head": {"kernel": params["lm_head"]["kernel"].float()}}
        ref32 = logits_from_hidden(head32, h32[:, P:P + n], cfg32)
        del head32
    dv = (dec - fwd)[..., :V].abs().max().item()
    own = (ref16 - ref32)[..., :V].abs().max().item()
    log(f"[rwkv] teacher-forced decode_step at positions {P}..{P + n - 1} "
        f"after a {P}-token prefill_cached: max|decode - kernel forward| "
        f"logits {dv:.4g}; plain bf16 forward vs fp32 {own:.4g} (limit "
        f"{TF_RATIO} x that)")
    if dv > TF_RATIO * own:
        raise AssertionError("rwkv: decode logits left the kernel forward")
    log(f"[rwkv] decode state: {state_short} bytes after a {P}-token "
        f"prompt, {state_long} after a {T}-token prompt "
        f"({state_long / 2 ** 20:.2f} MiB per sequence)")
    if state_short != state_long:
        raise AssertionError("rwkv: the decode state grew with the prompt")
    del hk, hs, h32, cache
    # -- greedy serving through the CLI's static batch --------------------
    report = serve_main(["--engine", "batch", "--arch", cfg.name,
                         "--batch", "4", "--prompt-len", "512", "--gen",
                         "32", "--device", str(dev)])
    if report["output_shape"] != [4, 512 + 32]:
        raise AssertionError(f"serve: {report}")
    log(f"[rwkv] serve --engine batch: 4 greedy streams, prompt 512, "
        f"generate 32 on {report['device']}: wall {report['wall_s']} s, "
        f"{report['tokens_per_s']} tokens/s")
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else 0.0)
    log(f"[rwkv] peak device memory {peak:.2f} GiB")
    return launches


def wkv_bound(ins):
    """Least time on an H100 SXM: r, k, v, w and u read once, out (in r's
    dtype) written once; or about 5 D^2 fp32 operations per token and head
    (the dot product and the update) at 67 TFLOP/s; whichever is larger."""
    r = ins[0]
    B, S, H, D = r.shape
    nbytes = sum(t.numel() * t.element_size() for t in ins) \
        + r.numel() * r.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 5 * D * D * B * S * H / PEAK_OPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_wkv_timing(torch, dev, real):
    """Device time per call of the wkv kernel (CUDA events behind a queued
    sleep) at B 1 x S ``RWKV_SEQ`` on layer 0's inputs and at B 8 x S 2048
    (H 32, D 64, r/k/v bf16, w fp32: the model's types), beside the bound
    and each build's registers and spills; the plain version once at each
    shape.  No single PyTorch call computes the recurrence, so there is no
    library time."""
    from repro_torch.kernels.wkv6 import kernel, ref
    build_report("wkv6")
    out = {}
    g = torch.Generator().manual_seed(4)
    r, k, v, w, u = real
    B8 = (8, 2048) + tuple(r.shape[2:])
    x8 = [torch.randn(B8, generator=g).to(dev, torch.bfloat16)
          for _ in range(3)]
    # the model's decay: exp(-exp(w0 + dd)), w0 = -4, dd about N(0, 0.6)
    x8.append(torch.exp(-torch.exp(-4.0 + 0.6 * torch.randn(
        B8, generator=g))).to(dev))
    for label, ins, reps in ((f"B 1 S {r.shape[1]}", real, 9),
                             ("B 8 S 2048", x8 + [u], 30)):
        fn = lambda: kernel.wkv6(*ins)  # noqa: E731
        for _ in range(3):
            med, lo, hi, held = event_ms(torch, fn, reps)
            if held:
                break
            log(f"[time] wkv {label}: the card drained its queue before "
                f"the host issued the last call; again")
        else:
            raise AssertionError(f"wkv timing {label}: the queue never held")
        b_ms, b_by = wkv_bound(ins)
        out[label] = dict(ms=med, plain_ms=None, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None)
        log(f"[time] wkv {label} H {ins[0].shape[2]} D {ins[0].shape[3]} "
            f"bf16 r/k/v, fp32 w: CUDA events per call, median {med:.4f} "
            f"ms of {reps} (least {lo:.4f}, most {hi:.4f}); bound "
            f"{b_ms:.4f} ms ({b_by}); library: none (no PyTorch call "
            f"computes this recurrence)")
    for label, ins in ((f"B 1 S {r.shape[1]}", real),
                       ("B 8 S 2048", x8 + [u])):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        ref.wkv(*ins)
        stop.record()
        torch.cuda.synchronize()
        plain = start.elapsed_time(stop)
        out[label]["plain_ms"] = plain
        log(f"[time] wkv plain version (the exact scan, one step a token) "
            f"{label}: {plain:.1f} ms, one call between CUDA events")
    return out


# ---------------------------------------------------------------------------
# phases 16 to 18: the hybrid-SSM, encoder-decoder and image-prefix
# families at full width, serving and training, and the GA's legacy mix
# ---------------------------------------------------------------------------

FAMILY_NAMES = ("hymba-1.5b", "whisper-small", "paligemma-3b")
FAMILY_SERVE = dict(B=4, P=32, G=32)
# hymba through the legacy engine: one dispatch per slot and token
FAMILY_LEGACY = dict(B=4, P=16, G=16)
# (batch, text tokens) of a train step: hymba past its 1024-token window,
# whisper at its 448-token decoder context over 1500 frames, paligemma
# with its 256-token image prefix before 256 text tokens
FAMILY_TRAIN = {"hymba-1.5b": (1, 2048), "whisper-small": (4, 448),
                "paligemma-3b": (1, 256)}
# phase 17: fp32 grads, the flash path against plain attention, worst
# leaf.  The two sum in other orders, and hymba's 32 layers carry the
# difference into its SSM's grads (w_c 6.4e-4 from plain in an fp32 run,
# a 32-token window 1.6)
FAMILY_GRAD_TOL = 1e-2


def family_stacks(params):
    """The layer stacks of a parameter tree: the decoder's, and the
    encoder's where there is one."""
    return [params["layers"]] + ([params["encoder"]["layers"]]
                                 if "encoder" in params else [])


def family_model(torch, dev, name):
    """``name`` at full published width, random bf16 weights from seed 0,
    the output projections of self attention, the SSM and the MLP scaled
    by ``BRANCH_GAIN``, and by sqrt(d_model) more where the embeddings
    are (gemma's scaling, paligemma), as phase 5 scales gemma-2b's: so
    greedy streams vary.  Cross attention keeps its scale: over the zero
    frames it adds the same vector at every position of every request,
    which scaled up would set every token alike.  Returns (cfg,
    params)."""
    from repro_torch.config import get_config
    from repro_torch.models import model as M
    cfg = get_config(name)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device=dev)
    gain = BRANCH_GAIN * (cfg.d_model ** 0.5
                          if cfg.family in ("dense", "vlm")
                          and cfg.act == "geglu" else 1.0)
    for st in family_stacks(params):
        for k in ("attn", "mlp"):
            st[k]["wo"].mul_(gain)
        if "ssm" in st:
            st["ssm"]["w_out"].mul_(gain)
    sync(torch, dev)
    log(f"[{name}] {M.count_params(cfg) / 1e9:.3f} B parameters "
        f"({cfg.dtype}; {cfg.n_layers} layers"
        + (f" + {cfg.n_encoder_layers} encoder layers over "
           f"{cfg.encoder_seq} frames" if cfg.n_encoder_layers else "")
        + (f", a {cfg.n_image_tokens}-token image prefix"
           if cfg.n_image_tokens else "")
        + (f", SSM state {cfg.ssm_state}, window {cfg.sliding_window} "
           f"on all but {cfg.n_global_layers} layers"
           if cfg.parallel_ssm else "")
        + f") initialised in {time.perf_counter() - t0:.1f} s, output "
        f"projections x{gain:.2f}")
    return cfg, params


def family_logits(torch, cfg, params, seq, P):
    """Logits (fp32, real vocab) predicting tokens P.. of ``seq`` (B, T)
    two ways: the serving path (``prefill_cached`` on the prompt, then one
    ``decode_step`` a token, teacher-forced) and the whole-sequence
    ``forward``.  Both get the zero image embeddings or frames that
    ``generate`` serves with.  Returns (decode, forward)."""
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models import model as M
    from repro_torch.models.layers import logits_from_hidden
    B, T = seq.shape
    n, V = cfg.n_image_tokens or 0, cfg.vocab
    stub = stub_inputs(cfg, B, seq.device)
    with torch.no_grad():
        h = M.forward(cfg, params, dict(stub, tokens=seq))
        fwd = logits_from_hidden(params, h[:, n + P - 1:n + T - 1],
                                 cfg).float()[..., :V]
        del h
        cache = M.init_cache(cfg, B, n + T, device=seq.device)
        h, cache = M.prefill_cached(cfg, params,
                                    dict(stub, tokens=seq[:, :P]), cache)
        dec = [logits_from_hidden(params, h[:, -1:], cfg).float()[..., :V]]
        for t in range(P, T - 1):
            lg, cache = M.decode_step(cfg, params, cache, seq[:, t:t + 1],
                                      n + t)
            dec.append(lg.float()[..., :V])
    return torch.cat(dec, 1), fwd


def phase_families_serving(torch, dev):
    """hymba-1.5b, whisper-small and paligemma-3b at full width through
    ``launch/serve --engine batch`` (4 x (32 + 32)), hymba also through
    ``--engine legacy`` (4 x (16 + 16), the prompts ``run`` draws from
    seed 1; streams held to ``generate``'s up to a near-tie under
    ``SPEC_TIE``, and in fp32 under ``FP32_TIE``).  Teacher-forced on the served tokens: the serving
    path's bf16 logits within ``TF_RATIO`` times the bf16 forward's own
    distance from the fp32 forward; then in fp32 the serving path within
    ``FP32_TF`` of the forward's largest logit.  Returns {name: report}."""
    import dataclasses
    import numpy as np
    from repro_torch.launch.serve import generate, parse_args, run
    S = FAMILY_SERVE
    out = {}
    for name in FAMILY_NAMES:
        t_phase = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg, params = family_model(torch, dev, name)
        tag = f"[{name}]"
        base = ["--arch", name, "--batch", str(S["B"]), "--prompt-len",
                str(S["P"]), "--gen", str(S["G"]), "--device", dev.type]
        report, toks = run(cfg, params, parse_args(["--engine", "batch"]
                                                   + base))
        P, G = S["P"], S["G"]
        if tuple(toks.shape) != (S["B"], P + G):
            raise AssertionError(f"{tag} --engine batch served "
                                 f"{tuple(toks.shape)}")
        streams = toks[:, P:].cpu().tolist()
        varied(f"{name} --engine batch", streams)
        log(f"{tag} --engine batch: {report['tokens_per_s']} tokens/s, "
            f"wall {report['wall_s']} s")
        rec = {"batch_tokens_per_s": report["tokens_per_s"]}
        if name == "hymba-1.5b":
            Lg = FAMILY_LEGACY
            rep_l, got = run(cfg, params, parse_args(
                ["--engine", "legacy", "--arch", name, "--batch",
                 str(Lg["B"]), "--prompt-len", str(Lg["P"]), "--gen",
                 str(Lg["G"]), "--device", dev.type]))
            prompts = np.random.default_rng(1).integers(
                0, cfg.vocab, (Lg["B"], Lg["P"]), dtype=np.int32)
            seq, top2 = generate(cfg, params,
                                 torch.from_numpy(prompts).to(dev), Lg["G"],
                                 return_top2=True)
            rec["legacy_exact"] = held_to_generate(
                f"{tag} --engine legacy {Lg['B']} x ({Lg['P']} + "
                f"{Lg['G']})", [got[i] for i in sorted(got)],
                seq[:, Lg["P"]:].cpu().tolist(), top2.cpu(), SPEC_TIE)
            rec["legacy_tokens_per_s"] = rep_l["tokens_per_s"]
            log(f"{tag} --engine legacy: {rep_l['tokens_per_s']} tokens/s, "
                f"{rep_l['dispatches']} dispatches")
        dec16, fwd16 = family_logits(torch, cfg, params, toks, P)
        cast_fp32(params)
        c32 = dataclasses.replace(cfg, dtype="float32")
        if name == "hymba-1.5b":
            # bf16 logits near 200 round to whole numbers, so bf16 streams
            # tie often; in fp32 the legacy engine must equal generate
            _, got = run(c32, params, parse_args(
                ["--engine", "legacy", "--arch", name, "--batch",
                 str(Lg["B"]), "--prompt-len", str(Lg["P"]), "--gen",
                 str(Lg["G"]), "--device", dev.type]))
            seq, top2 = generate(c32, params,
                                 torch.from_numpy(prompts).to(dev), Lg["G"],
                                 return_top2=True)
            rec["legacy_exact_fp32"] = held_to_generate(
                f"{tag} fp32 --engine legacy", [got[i] for i in sorted(got)],
                seq[:, Lg["P"]:].cpu().tolist(), top2.cpu(), FP32_TIE)
        _, fwd32 = family_logits(torch, c32, params, toks, P)
        dec_err = (dec16 - fwd32).abs().max().item()
        own_err = (fwd16 - fwd32).abs().max().item()
        del dec16, fwd16, fwd32
        log(f"{tag} teacher-forced on the served tokens: against the fp32 "
            f"forward, the bf16 serving path {dec_err:.4f}, the bf16 "
            f"forward {own_err:.4f} (allowed {TF_RATIO:g}x)")
        if not dec_err <= TF_RATIO * own_err:
            raise AssertionError(f"{tag} the serving path's logits are "
                                 f"further from fp32 than bf16 rounding "
                                 f"explains")
        seq32 = generate(c32, params, toks[:, :P], G)
        dec32, fwd32 = family_logits(torch, c32, params, seq32, P)
        err, scale = ((dec32 - fwd32).abs().max().item(),
                      fwd32.abs().max().item())
        del dec32, fwd32
        log(f"{tag} fp32: the serving path against the forward over "
            f"{S['B']}x{P + G} tokens: max diff {err:.3e}, largest logit "
            f"{scale:.3f} (allowed {FP32_TF:g} of it)")
        if not err <= FP32_TF * scale:
            raise AssertionError(f"{tag} fp32: the serving path leaves the "
                                 f"forward")
        del params
        sync(torch, dev)
        rec.update(fp32_err=err, tf_err=dec_err, own_err=own_err,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   seconds=time.perf_counter() - t_phase)
        log(f"{tag} serving phase {rec['seconds']:.1f} s, peak memory "
            f"{rec['peak_gib']:.1f} GiB")
        out[name] = rec
    torch.cuda.empty_cache()
    return out


def phase_families_train(torch, dev):
    """Each family at full width (fp32 masters, bf16 compute, remat full;
    random weights from seed 0, the final norm scaled so the logits have a
    std of 1) on the flash path where the JAX package takes its kernel
    (unrolled, no image prefix).  One ``loss_and_grads`` launches what the
    code implies (2 L forward with lse, L dq, L dk/dv over the L layers
    that attend by themselves: hymba's 32, whisper's 12 + 12, none for
    paligemma) and its loss matches plain attention's.  The gradients are
    held in fp32 compute, the flash path on the fp32 kernels against plain
    fp32 attention, every leaf within ``FAMILY_GRAD_TOL`` and below a
    32-token window in every windowed layer (hymba's 29 local ones,
    whisper's decoder): in bf16 both paths sit about 1 from fp32 on
    hymba's attention projections (a softmax over a thousand keys leaves
    dq a difference of near-equal sums), too far to tell a wrong
    attention.  Then a timed ``make_train_step`` step at
    ``FAMILY_TRAIN``'s shape with those launches, its device busy under
    ``torch.profiler`` and the peak memory.  Returns {name: report} with
    the step's flash launches."""
    import dataclasses
    from repro_torch.config import ShapeConfig, get_config
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.steps import (TrainState, loss_and_grads,
                                         make_train_step)
    out = {}
    for name in FAMILY_NAMES:
        t_phase = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = get_config(name)
        cfg = dataclasses.replace(base, use_pallas_attention=True,
                                  scan_layers=False)
        plain = dataclasses.replace(base, scan_layers=False)
        tag = f"[{name} train]"
        B, S = FAMILY_TRAIN[name]
        n_img = cfg.n_image_tokens or 0
        Lf = 0 if n_img else cfg.n_layers + cfg.n_encoder_layers
        want = {"fwd": 0, "fwd_lse": 2 * Lf, "dq": Lf, "dkv": Lf}
        params = M.init_params(cfg, seed=0, device=dev,
                               param_dtype=torch.float32)
        # random tied embeddings give logits of std sqrt(d_model) (40 for
        # hymba), a saturated softmax; the final norm's scale cut to
        # 1 / sqrt(d) gives logits of std 1
        params["final_ln"]["scale"].mul_(cfg.d_model ** -0.5)
        batch_fn = make_batch_fn(cfg, ShapeConfig(name, S + n_img, B,
                                                  "train"), seed=0)
        b0 = {k: v.to(dev) for k, v in batch_fn(0).items()}
        log(f"{tag} {M.count_params(cfg) / 1e9:.3f} B fp32 masters; batch "
            f"{B} x {S} text tokens"
            + (f" after a {n_img}-token image prefix" if n_img else "")
            + (f" over {cfg.encoder_seq} frames"
               if cfg.n_encoder_layers else ""))
        zero_flash_counts()
        loss_f, _, g_f = loss_and_grads(cfg, params, b0)
        sync(torch, dev)
        once = flash_counts()
        del g_f
        with torch.no_grad():
            loss_p = M.loss_fn(plain, params, b0)[0]
        lf, lp = loss_f.item(), loss_p.item()
        log(f"{tag} first step loss (bf16): flash {lf:.6f}, plain {lp:.6f};"
            f" flash launches {once} (the code implies {want})")
        if not (math.isfinite(lf) and abs(lf - lp) <= LOSS_RTOL * abs(lp)):
            raise AssertionError(f"{tag} the flash path's loss differs from "
                                 f"plain attention's")
        if once != want:
            raise AssertionError(f"{tag} one loss_and_grads launched {once}, "
                                 f"the code implies {want}")
        err = None
        if Lf:
            c32 = dataclasses.replace(cfg, dtype="float32")
            _, _, g_f = loss_and_grads(c32, params, b0)
            _, _, g_p = loss_and_grads(
                dataclasses.replace(plain, dtype="float32"), params, b0)
            err, at = leaf_errs(torch, g_f, g_p)
            del g_f
            # a wrong attention: a window of 32 tokens (fewer on a short
            # text) in every windowed layer
            win = min(32, S // 4)
            _, _, g_w = loss_and_grads(
                dataclasses.replace(c32, sliding_window=win), params, b0)
            wrong_err, _ = leaf_errs(torch, g_w, g_p)
            del g_w, g_p
            judge(f"{name} fp32 grads", err, FAMILY_GRAD_TOL,
                  {f"a {win}-token window": wrong_err},
                  extra=f"; worst at {at}; flash on the fp32 kernels "
                        f"against plain fp32 attention",
                  what="worst leaf's ||flash - plain|| / ||plain||")
        else:
            log(f"{tag} no flash path (an image prefix): the loss is plain "
                f"attention's")
        log(f"{tag} checks done {time.perf_counter() - t_phase:.1f} s into "
            f"the phase")
        st = TrainState(params, adamw_init(params, AdamWConfig()),
                        torch.zeros((), dtype=torch.int32, device=dev))
        del params
        # the loss_and_grads calls above warmed the step's kernels
        step = make_train_step(cfg, base_lr=3e-4, warmup=2, total_steps=10)
        sync(torch, dev)
        zero_flash_counts()
        t0 = time.perf_counter()
        st, m = step(st, batch_fn(1))
        sync(torch, dev)
        wall = (time.perf_counter() - t0) * 1e3
        got = flash_counts()
        loss = m["loss"].item()
        if got != want or not math.isfinite(loss):
            raise AssertionError(f"{tag} a step launched {got}, the code "
                                 f"implies {want}; loss {loss}")
        rows = profiled(torch, lambda: step(st, batch_fn(2)), 1)
        busy = sum(r[0] for r in rows) / 1e3
        flash = sum(r[0] for r in rows if "flash_" in r[2]) / 1e3
        blas = sum(r[0] for r in rows
                   if any(s in r[2] for s in BLAS_KERNELS)) / 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        del st
        rec = dict(launches=got, step_ms=wall, busy_ms=busy,
                   flash_ms=flash, blas_ms=blas, launches_on_card=sum(
                       r[1] for r in rows), peak_gib=peak, loss=loss,
                   grad_err=err, seconds=time.perf_counter() - t_phase)
        log(f"{tag} a step: wall {wall:.1f} ms, loss {loss:.4f}, flash "
            f"launches {got}; device busy {busy:.1f} ms (idle share "
            f"{1 - busy / wall:.3f}), flash kernels {flash:.1f} ms, cuBLAS "
            f"{blas:.1f} ms, {rec['launches_on_card']} launches on the card"
            f"; peak memory {peak:.1f} GiB; phase {rec['seconds']:.1f} s")
        for us, n, key in rows[:6]:
            log(f"{tag}   {us / 1e3:.3f} ms x{n}  {key[:90]}")
        out[name] = rec
    torch.cuda.empty_cache()
    return out


def phase_legacy_ga(torch, dev, problem):
    """The GA's legacy operator mix (``GAConfig(rgenoud_operators=
    False)``: blend / uniform crossover, Gaussian, reset and boundary
    mutations) at the paper's scale on phase 8's problem: the best
    fitness of the initial population and after 50 generations (never
    rising, ending lower), the best w scored by the plain version, the
    fitness kernel's launches (``1 + generations x (polish_steps + 2)``),
    generations/s.  Returns (launches, report)."""
    from repro_torch.core import catopt
    from repro_torch.kernels.recovery import kernel, ref
    cfg = catopt.GAConfig(rgenoud_operators=False)
    gen = torch.Generator(device=dev).manual_seed(11)
    with torch.no_grad():
        pop0 = catopt._init_pop(gen, cfg.pop_size, problem.n_dims, dev)
        before = float(catopt.basis_risk(problem, pop0).min())
    sync(torch, dev)
    kernel.launches = 0
    t0 = time.perf_counter()
    res = catopt.optimize_island(problem, cfg, seed=12, pop0=pop0,
                                 device=dev)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = kernel.launches
    hist = res["history"].cpu().numpy()
    plain = float(ref.basis_risk(problem.industry_losses,
                                 problem.target_recovery, res["w"][None],
                                 problem.attachment, problem.limit,
                                 problem.weight_budget)[0])
    expect = 1 + cfg.generations * (cfg.polish_steps + 2)
    gens_s = cfg.generations / wall
    log(f"[legacy GA] E {problem.n_events} m {problem.n_dims}, pop "
        f"{cfg.pop_size}, {cfg.generations} generations of the legacy mix: "
        f"{wall:.3f} s = {gens_s:.2f} generations/s; best fitness "
        f"{before:.4f} (initial population) -> {hist[0]:.4f} (generation "
        f"1) -> {hist[-1]:.4f} (plain version on the best w: {plain:.4f});"
        f" kernel launches {launches} (1 + {cfg.generations} x "
        f"({cfg.polish_steps} + 2) = {expect})")
    if not ((hist[1:] <= hist[:-1]).all() and hist[-1] < before):
        raise AssertionError("legacy GA: the best fitness rose, or never "
                             "fell")
    if not abs(plain - float(res["fitness"])) <= 1e-4 * plain:
        raise AssertionError("legacy GA: the best w does not score its "
                             "fitness")
    if launches != expect:
        raise AssertionError("legacy GA: the fitness did not run through "
                             "the kernel once per call")
    breakdown = ga_breakdown(torch, dev, problem, cfg)
    return launches, dict(before=before, after=float(hist[-1]),
                          gens_per_s=gens_s, **breakdown)


def timing_main(src):
    """``--timing-only [--src DIR]``: phases 1, 6, 6b, 9 and 15, the GA
    generation's breakdown and the fp and int8 decode ticks' alone, on the
    ``repro_torch`` package under ``DIR`` (default: this repository's
    ``src``), building only the kernels they time.  Run it on two trees in
    one call (parent, change, change, parent) to compare them on one card.
    The last line is {"timing": ..., "src": ..., "gpu": ...}."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(src))
    import repro_torch
    from repro_torch.core.catopt import make_problem
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = phase_gpu_info()
    log(f"[timing] repro_torch from {os.path.dirname(repro_torch.__file__)}")
    _build.build(["paged_attention", "copy_page", "fitness", "wkv6"])
    timing = phase_timing(torch, dev)
    timing.update(phase_family_timing(torch, dev))
    problem = make_problem(seed=0, n_events=PAPER["E"], n_dims=PAPER["m"],
                           device=dev)
    timing.update({f"fitness {k}": v for k, v in
                   phase_fitness_timing(torch, dev, problem).items()})
    from repro_torch.core.catopt import GAConfig
    timing["generation"] = ga_breakdown(torch, dev, problem, GAConfig(),
                                        gens=20)
    del problem
    cfg, params, prompts, kw = gemma_serving(torch, dev)
    for label, extra in (("fp", {}), ("int8", dict(kv_dtype="int8"))):
        timing[f"tick {label}"] = tick_breakdown(
            torch, cfg, params, prompts, 32, dict(kw, **extra),
            label=f" {label} pages")
    del cfg, params, prompts
    cfg_rw, rw_params, rw_toks = rwkv_model(torch, dev)
    real = layer0_inputs(torch, cfg_rw, rw_params, rw_toks)
    del rw_params
    timing.update({f"wkv {k}": v for k, v in
                   phase_wkv_timing(torch, dev, real).items()})
    log(json.dumps({"timing": timing, "src": os.path.abspath(src),
                    "gpu": gpu}))
    return 0


def main():
    import torch
    if "--timing-only" in sys.argv[1:]:
        args = sys.argv[1:]
        src = (args[args.index("--src") + 1] if "--src" in args
               else os.path.join(HERE, "src"))
        return timing_main(src)
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
    family_err = phase_family_vs_plain(torch, dev)
    phase_reduced_exact(torch, dev)
    full = phase_full_width(torch, dev)
    family_launches = phase_full_width_options(torch, dev, full, family_err)
    spec_launches = phase_full_width_spec_swap(torch, dev, full)
    spec_launches.update(phase_frontends(torch, dev, full))
    fp_launches = full["launches"]
    del full                            # the full-width weights
    torch.cuda.empty_cache()
    moe_launches, _ = phase_moe_full_width(torch, dev, family_err)
    spec_launches.update(moe_launches)
    spec_launches.update(phase_other_configs(torch, dev)[0])
    families = phase_families_serving(torch, dev)
    timing = phase_timing(torch, dev)
    family_timing = phase_family_timing(torch, dev)
    flash_err = phase_flash_vs_plain(torch, dev)
    train = phase_train_full_width(torch, dev)
    phase_train_launcher(torch, dev)
    family_train = phase_families_train(torch, dev)
    flash_time = phase_flash_timing(torch, dev)
    from repro_torch.core.catopt import make_problem
    problem = make_problem(seed=0, n_events=PAPER["E"], n_dims=PAPER["m"],
                           device=dev)
    fit_abs, fit_rel = phase_fitness_vs_plain(torch, dev, problem)
    fit_launches, _ = phase_catopt(torch, dev, problem)
    legacy_launches, legacy = phase_legacy_ga(torch, dev, problem)
    fit_time = phase_fitness_timing(torch, dev, problem)
    fit = fit_time["paper"]
    del problem
    cfg_rw, rw_params, rw_toks = rwkv_model(torch, dev)
    real = layer0_inputs(torch, cfg_rw, rw_params, rw_toks)
    wkv_abs, wkv_row = phase_wkv_vs_plain(torch, dev, real)
    wkv_launches = phase_rwkv_full_width(torch, dev, cfg_rw, rw_params,
                                         rw_toks)
    del rw_params
    wkv = phase_wkv_timing(torch, dev, real)[f"B 1 S {RWKV_SEQ}"]
    dec = timing["decode"]

    def entry(name, source, replaces, launches, err, t):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, **t}

    def paths(key):
        """A kernel's launches on each of phase 5b's speculation, swap and
        host-tier runs, phase 5c's open-loop and router runs and phases
        5d and 5e's models that launched it."""
        return {"launches_by_path": {label: c[key]
                                     for label, c in spec_launches.items()
                                     if c[key]}}

    def trained(*keys):
        """A flash kernel's launches in each family's timed train step
        (phase 17)."""
        return {"launches_by_path": {
            f"{name} train step": sum(r["launches"][k] for k in keys)
            for name, r in family_train.items()}}

    report = {"kernels": [
        entry("paged_attention_update", KERNEL_SOURCE, KERNEL_REPLACES,
              fp_launches, max(max_err, family_err["verify"]),
              dict(dec, d128=timing["decode D128"],
                   max_abs_err_d128=family_err["d128"], **paths("fp"))),
        entry("paged_attention_update_int8", KERNEL_SOURCE, INT8_REPLACES,
              family_launches["int8"], family_err["int8"],
              dict(family_timing["int8 decode"],
                   d128=family_timing["int8 decode D128"], **paths("int8"))),
        entry("paged_attention", KERNEL_SOURCE, READONLY_REPLACES,
              family_launches["readonly"], family_err["readonly"],
              dict(family_timing["read-only fp"],
                   d128=family_timing["read-only fp D128"],
                   **paths("readonly"))),
        # per copy-on-write over gemma-2b's whole cache (fp pages; int8
        # pages and the one-pool call beside it)
        entry("copy_page", COPY_SOURCE, COPY_REPLACES,
              family_launches["copy"], family_err["copy"],
              dict(family_timing["copy per COW fp"],
                   int8=family_timing["copy per COW int8"],
                   single_pool=family_timing["copy_page"], **paths("copy"))),
        entry("flash_attention_pallas", FLASH_SOURCE,
              FLASH_REPLACES["fwd"], train["launches"]["fwd"],
              flash_err["fwd"], dict(flash_time[("(a)", "fwd")],
                                     **trained("fwd"))),
        entry("flash_attention_fwd_lse", FLASH_SOURCE,
              FLASH_REPLACES["fwd_lse"], train["launches"]["fwd_lse"],
              flash_err["fwd_lse"], dict(flash_time[("(a)", "fwd_lse")],
                                         **trained("fwd_lse"))),
        entry("flash_attention_bwd", FLASH_SOURCE, FLASH_REPLACES["bwd"],
              train["launches"]["dq"] + train["launches"]["dkv"],
              flash_err["bwd"], dict(flash_time[("(a)", "bwd")],
                                     **trained("dq", "dkv"))), {
        "name": "fitness_sq", "route": "cuda",
        "source": FIT_SOURCE, "replaces": FIT_REPLACES,
        "launches": fit_launches, "max_abs_err": fit_abs,
        "max_rel_err": fit_rel,
        "ms": fit["ms"], "plain_ms": fit["plain_ms"],
        "bound_ms": fit["bound_ms"], "bound_by": fit["bound_by"],
        "library_ms": fit["library_ms"], "polish": fit_time["polish"],
        "launches_by_path": {"legacy operator mix": legacy_launches}},
        entry("wkv6", WKV_SOURCE, WKV_REPLACES, wkv_launches, wkv_abs,
              dict(wkv, max_row_err=wkv_row,
                   library="none: no single PyTorch call computes the "
                           "RWKV-6 recurrence"))]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {gpu}")
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
