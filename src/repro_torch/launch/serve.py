"""Serving entry point of the PyTorch port: the isolated greedy oracle and the
command line of its paged engine and static batch.  The counterpart of
``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --engine paged --batch 4 --prompt-len 32 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --engine batch --batch 4 --prompt-len 512 --gen 32

runs on the GPU (``--device cpu --reduced`` runs the plain PyTorch path on
the CPU) and prints the JAX CLI's JSON report: wall time and tokens/s, plus
the paged engine's ``metrics()`` fields.  ``--engine batch`` is the JAX
CLI's static batched ``generate``, greedy only; it serves every family the
port runs, the RWKV family from its constant-size state.  Weights are
random, from the port's seeded ``init_params``; prompts come from
``--seed``.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.config import get_config, reduced
from repro_torch.models import model as M
from repro_torch.models.layers import logits_from_hidden


@torch.no_grad()
def generate(cfg, params, prompts: torch.Tensor, gen: int, *,
             return_top2: bool = False
             ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Isolated greedy decoding through a decode cache (dense K/V, or the
    RWKV state): prompts (B, S0) -> (B, S0 + gen) tokens on the prompts'
    device.  The oracle every engine test holds the paged engine to.

    With ``return_top2`` also returns the (B, gen, 2) fp32 values of the
    two largest logits at each step: how close each greedy choice was.
    """
    B, S0 = prompts.shape
    cache = M.init_cache(cfg, B, S0 + gen, device=prompts.device)
    hidden, cache = M.prefill_cached(cfg, params, {"tokens": prompts}, cache)
    logits = logits_from_hidden(params, hidden[:, -1:], cfg)
    toks = prompts
    top2: List[torch.Tensor] = []
    for i in range(gen):
        last = logits[:, -1].float()
        if return_top2:
            top2.append(torch.topk(last, 2, dim=-1).values)
        nxt = torch.argmax(last, dim=-1)[:, None].to(prompts.dtype)
        toks = torch.cat([toks, nxt], dim=1)
        if i + 1 < gen:
            logits, cache = M.decode_step(cfg, params, cache, nxt,
                                          toks.shape[1] - 1)
    if return_top2:
        return toks, torch.stack(top2, dim=1)
    return toks


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", choices=("batch", "paged"),
                    default="paged",
                    help="serving path: 'batch' the static batched greedy "
                         "generate, 'paged' the paged engine")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV page size")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="per-tick token cap for the unified tick (0 = "
                         "unbounded packing)")
    ap.add_argument("--tick", choices=("unified", "legacy"),
                    default="unified",
                    help="'unified' runs prefill chunks and decodes in one "
                         "pass (DESIGN.md §8); 'legacy' the two-dispatch "
                         "tick")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="automatic prefix caching: ref-counted pages, "
                         "content-hash prompt matching, copy-on-write "
                         "(DESIGN.md §9)")
    ap.add_argument("--speculate", action="store_true",
                    help="self-speculative decoding: n-gram drafts "
                         "verified in the tick, byte-identical greedy "
                         "streams (DESIGN.md §11)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="most draft tokens a request proposes a tick "
                         "(with --speculate)")
    ap.add_argument("--kv-dtype", choices=("fp", "int8"), default="fp",
                    help="KV page storage: 'int8' stores pages quantized "
                         "with per-row fp32 scales (DESIGN.md §13)")
    ap.add_argument("--preempt", choices=("recompute", "swap"),
                    default="recompute",
                    help="preemption: 'swap' parks the victim's KV pages "
                         "in host RAM and copies them back on resume "
                         "instead of recomputing (DESIGN.md §13)")
    ap.add_argument("--host-cache-pages", type=int, default=0,
                    help="host-RAM tier, in pages, for evicted "
                         "prefix-cache pages (with --prefix-cache; 0 "
                         "disables it)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    args = ap.parse_args(argv)
    if args.engine != "paged" and (args.token_budget or
                                   args.tick != "unified" or
                                   args.prefix_cache or args.speculate or
                                   args.kv_dtype != "fp" or
                                   args.preempt != "recompute" or
                                   args.host_cache_pages):
        ap.error("--token-budget/--tick/--prefix-cache/--speculate/"
                 "--kv-dtype/--preempt/--host-cache-pages are paged-engine "
                 "knobs")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = M.init_params(cfg, seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed + 1)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    dev = torch.device(args.device)
    if args.engine == "batch":
        toks = torch.from_numpy(prompts).to(dev)
        t0 = time.time()
        out = generate(cfg, params, toks, args.gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.time() - t0
        n_tokens = args.batch * args.gen
        shape, extra = list(out.shape), {}
    else:
        results, extra, wall = _serve_paged(cfg, params, prompts, args)
        n_tokens = sum(len(v) for v in results.values())
        shape = [len(results)]
    report = {
        "arch": cfg.name, "engine": args.engine, "batch": args.batch,
        "prompt_len": args.prompt_len, "generated": args.gen,
        "device": (torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu"),
        "wall_s": round(wall, 3),
        "tokens_per_s": round(n_tokens / wall, 1),
        "output_shape": shape,
        **extra,
    }
    print(json.dumps(report, indent=1))
    return report


def _serve_paged(cfg, params, prompts: np.ndarray, args
                 ) -> Tuple[dict, dict, float]:
    """Serve ``prompts`` through the paged engine.  Returns (streams by
    request id, the engine's metrics, wall seconds)."""
    from repro_torch.serving import PagedServingEngine

    max_seq = args.prompt_len + args.gen + 1
    eng = PagedServingEngine(
        cfg, params, max_slots=args.batch, block_size=args.block_size,
        max_blocks_per_seq=-(-max_seq // args.block_size),
        token_budget=args.token_budget or None,
        unified=args.tick == "unified", prefix_cache=args.prefix_cache,
        speculate=args.speculate, draft_k=args.draft_k,
        kv_dtype=args.kv_dtype, preempt=args.preempt,
        host_cache_pages=args.host_cache_pages, device=args.device)
    t0 = time.time()
    for row in prompts:
        eng.submit(row, args.gen)
    results = eng.run_to_completion()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return results, eng.metrics(), time.time() - t0


if __name__ == "__main__":
    main()
