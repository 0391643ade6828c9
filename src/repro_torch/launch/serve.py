"""Serving entry point of the PyTorch port: the isolated decoding oracle and
the command line of its engines.  The counterpart of
``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --engine paged --batch 4 --prompt-len 32 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --engine paged --open-loop --mix chat --arrivals poisson \
        --rate 20 --requests 32 --slo-ttft 0.5
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --engine batch --batch 4 --prompt-len 512 --gen 32

runs on the GPU (``--device cpu --reduced`` runs the plain PyTorch path on
the CPU) and prints the JAX CLI's JSON report: wall time and tokens/s, plus
the engine's ``metrics()`` fields.

``--engine`` selects the serving path: ``batch`` (the static batched
``generate``, greedy or sampled at ``--temperature``; it serves every
family the port runs, the RWKV family from its constant-size state,
paligemma-3b and whisper-small with zero image and audio inputs),
``legacy`` (per-slot continuous batching over a dense cache,
``repro_torch.core.serving``: decoder-only stacks, hymba-1.5b among them)
or ``paged`` (the paged engine, ``repro_torch.serving``; the default;
pure-attention decoders only).  ``--replicas N`` serves through N
paged engines behind a ``ReplicaRouter`` (``--routing affinity`` or
``rr``), all on the one device and one weight set.  ``--open-loop`` serves
a seeded ``repro_torch.serving.loadgen`` workload (``--mix`` x
``--arrivals``, paced by ``--rate`` or replayed from ``--trace-file``)
through ``ServingFrontend`` on the wall clock; the report carries the SLO
scorecard under ``open_loop``.  ``--trace PATH`` dumps the paged engine's
telemetry (JSONL, or Chrome trace_event for ``.json``; one merged JSONL
stream with ``--replicas`` > 1).  Weights are random, from the port's
seeded ``init_params``; ``--seed`` also seeds the prompts, the open-loop
workload and the sampling noise.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.config import get_config, reduced
from repro_torch.models import model as M
from repro_torch.models.layers import logits_from_hidden


class GumbelDraws:
    """The seam for sampling's randomness: ``draws(i, shape)`` returns
    decode step i's standard Gumbel noise of ``shape`` (fp32) from
    ``generator``, in call order (i itself is not used: a replay can index
    by it).  Nothing here waits for the device."""

    def __init__(self, generator: torch.Generator, device: torch.device):
        self.gen, self.device = generator, device

    def __call__(self, i: int, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.device)
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(u.clamp_min(tiny)))


def stub_inputs(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    """The zero ``image_embeds`` / ``frames`` a prompt is served with
    (the vision and audio front ends are stubs), in the compute dtype;
    empty for a text-only config."""
    dt = getattr(torch, cfg.dtype)
    out: Dict[str, torch.Tensor] = {}
    if cfg.n_image_tokens:
        out["image_embeds"] = torch.zeros(
            (batch, cfg.n_image_tokens, cfg.d_model), dtype=dt, device=device)
    if cfg.n_encoder_layers:
        out["frames"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                    dtype=dt, device=device)
    return out


@torch.no_grad()
def generate(cfg, params, prompts: torch.Tensor, gen: int, *,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Callable[[int, tuple], torch.Tensor]] = None,
             return_top2: bool = False
             ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Isolated decoding through a decode cache (dense K/V, or the RWKV
    state): prompts (B, S0) -> (B, S0 + gen) tokens on the prompts'
    device.  Greedy at ``temperature`` 0: the oracle every engine test
    holds the engines to.

    At ``temperature`` > 0 each step samples as the JAX package's
    ``jax.random.categorical`` does: ``argmax(logits / T + g)`` with ``g``
    standard Gumbel noise over the (B, padded vocab) row, drawn by
    ``draws(i, shape)`` (default :class:`GumbelDraws` over ``generator``,
    a ``torch.Generator`` on the prompts' device, seeded 0 if not given).

    With ``return_top2`` also returns the (B, gen, 2) fp32 values of the
    two largest logits at each step: how close each greedy choice was.

    An image-prefix model (paligemma) gets zero ``image_embeds`` and an
    encoder-decoder (whisper) zero ``frames``, as in the JAX package, and
    a token's position counts the prefix.  The cache holds the prefix as
    well: JAX's ``generate`` sizes it for the text alone, so it raises
    when ``gen`` is below the prefix and writes the last ``n_image_tokens``
    decode steps over its last row (ROADMAP.md Queue 3).
    """
    B, S0 = prompts.shape
    if temperature > 0 and draws is None:
        if generator is None:
            generator = torch.Generator(device=prompts.device).manual_seed(0)
        draws = GumbelDraws(generator, prompts.device)
    n_prefix = cfg.n_image_tokens or 0
    cache = M.init_cache(cfg, B, n_prefix + S0 + gen, device=prompts.device)
    hidden, cache = M.prefill_cached(
        cfg, params, dict(stub_inputs(cfg, B, prompts.device),
                          tokens=prompts), cache)
    logits = logits_from_hidden(params, hidden[:, -1:], cfg)
    toks = prompts
    top2: List[torch.Tensor] = []
    for i in range(gen):
        last = logits[:, -1].float()
        if return_top2:
            top2.append(torch.topk(last, 2, dim=-1).values)
        if temperature > 0:
            noise = draws(i, tuple(last.shape)).to(last.device)
            nxt = torch.argmax(last / temperature + noise, dim=-1)
        else:
            nxt = torch.argmax(last, dim=-1)
        nxt = nxt[:, None].to(prompts.dtype)
        toks = torch.cat([toks, nxt], dim=1)
        if i + 1 < gen:
            logits, cache = M.decode_step(cfg, params, cache, nxt,
                                          n_prefix + toks.shape[1] - 1)
    if return_top2:
        return toks, torch.stack(top2, dim=1)
    return toks


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The command line, validated as the JAX CLI validates it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", choices=("batch", "legacy", "paged"),
                    default="paged",
                    help="serving path: 'batch' the static batched "
                         "generate, 'legacy' per-slot continuous batching "
                         "over a dense cache, 'paged' the paged engine")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (--engine batch; 0 = "
                         "greedy)")
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="paged engines behind a ReplicaRouter on the one "
                         "device (DESIGN.md §14); 1 drives the engine "
                         "directly")
    ap.add_argument("--routing", choices=("affinity", "rr"),
                    default="affinity",
                    help="replica placement (with --replicas > 1): "
                         "'affinity' probes each replica's page-digest "
                         "caches and falls back to pool-pressure "
                         "balancing under an anti-herd cap; 'rr' is "
                         "round-robin")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="dump the paged engine's telemetry trace here "
                         "after the run (DESIGN.md §10): JSONL, or Chrome "
                         "trace_event when PATH ends in .json; JSONL only "
                         "with --replicas > 1")
    ap.add_argument("--open-loop", action="store_true",
                    help="serve a seeded open-loop workload through "
                         "ServingFrontend instead of pre-staged prompts "
                         "(paged engine; DESIGN.md §12)")
    ap.add_argument("--mix", default="chat",
                    help="open-loop request-shape mix: chat, longdoc, "
                         "agents, or classify (repro_torch.serving.loadgen)")
    ap.add_argument("--arrivals", choices=("poisson", "bursty", "trace"),
                    default="poisson",
                    help="open-loop arrival process (trace replays "
                         "--trace-file)")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="mean arrival rate, req/s (--arrivals poisson)")
    ap.add_argument("--requests", type=int, default=32,
                    help="open-loop workload size")
    ap.add_argument("--trace-file", default=None, metavar="PATH",
                    help="arrival trace to replay (--arrivals trace): one "
                         "float per line, or JSONL with t/prompt_len/"
                         "max_new_tokens")
    ap.add_argument("--slo-ttft", type=float, default=None, metavar="S",
                    help="TTFT SLO in seconds for the goodput scorecard")
    ap.add_argument("--slo-tpot", type=float, default=None, metavar="S",
                    help="per-output-token SLO in seconds for the goodput "
                         "scorecard")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights, the prompts, the "
                         "open-loop workload (arrivals and request "
                         "content) and the sampling noise")
    args = ap.parse_args(argv)

    if args.engine != "batch" and args.temperature > 0:
        ap.error("--temperature is only supported with --engine batch "
                 "(the serving engines decode greedily)")
    if args.engine != "paged" and (args.token_budget or
                                   args.tick != "unified" or
                                   args.prefix_cache or args.speculate or
                                   args.kv_dtype != "fp" or
                                   args.preempt != "recompute" or
                                   args.host_cache_pages):
        ap.error("--token-budget/--tick/--prefix-cache/--speculate/"
                 "--kv-dtype/--preempt/--host-cache-pages are paged-engine "
                 "knobs")
    if args.trace is not None and args.engine != "paged":
        ap.error("--trace requires --engine paged (the telemetry lives in "
                 "the paged engine; DESIGN.md §10)")
    if args.open_loop and args.engine != "paged":
        ap.error("--open-loop requires --engine paged (the front end "
                 "serves over the paged engine; DESIGN.md §12)")
    if args.open_loop and args.arrivals == "trace" \
            and args.trace_file is None:
        ap.error("--arrivals trace needs --trace-file")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.replicas > 1 and args.engine != "paged":
        ap.error("--replicas/--routing require --engine paged (the router "
                 "fans out over paged engines; DESIGN.md §14)")
    if args.replicas > 1 and args.trace is not None \
            and args.trace.endswith(".json"):
        ap.error("merged multi-replica traces are JSONL-only; use a .jsonl "
                 "--trace path with --replicas > 1")
    return args


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = M.init_params(cfg, seed=args.seed, device=args.device)
    report, _ = run(cfg, params, args)
    print(json.dumps(report, indent=1))
    return report


def run(cfg, params, args: argparse.Namespace) -> Tuple[dict, Any]:
    """Serve as ``args`` (from :func:`parse_args`) say, with ``params`` on
    ``args.device``.  Returns (the JSON report, what was served): the
    (batch, prompt + gen) tokens for ``--engine batch``, else the streams
    by request id (front-end ids with ``--open-loop``)."""
    dev = torch.device(args.device)
    rng = np.random.default_rng(args.seed + 1)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    if args.engine == "batch":
        toks = torch.from_numpy(prompts).to(dev)
        generator = None
        if args.temperature > 0:
            generator = torch.Generator(device=dev).manual_seed(args.seed)
        t0 = time.time()
        out = generate(cfg, params, toks, args.gen,
                       temperature=args.temperature, generator=generator)
        _sync(dev)
        wall = time.time() - t0
        n_tokens = args.batch * args.gen
        shape, extra = list(out.shape), {}
    else:
        if args.open_loop:
            out, extra, wall = _serve_open_loop(cfg, params, args)
        else:
            out, extra, wall = _serve_engine(cfg, params, prompts, args)
        n_tokens = sum(len(v) for v in out.values())
        shape = [len(out)]
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
    return report, out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _paged(cfg, params, args, max_seq: int):
    """The paged engine ``args`` describe, or ``args.replicas`` of them
    behind a router, each sized for requests of up to ``max_seq``
    tokens."""
    from repro_torch.serving import PagedServingEngine, ReplicaRouter

    def build(i: int) -> PagedServingEngine:
        return PagedServingEngine(
            cfg, params, max_slots=args.batch, block_size=args.block_size,
            max_blocks_per_seq=-(-max_seq // args.block_size),
            token_budget=args.token_budget or None,
            unified=args.tick == "unified", prefix_cache=args.prefix_cache,
            speculate=args.speculate, draft_k=args.draft_k,
            kv_dtype=args.kv_dtype, preempt=args.preempt,
            host_cache_pages=args.host_cache_pages, device=args.device)

    if args.replicas > 1:
        return ReplicaRouter(build, args.replicas, routing=args.routing)
    return build(0)


def _finish(eng, args, extra: Dict[str, Any]) -> Dict[str, Any]:
    if args.trace is not None:
        extra["trace"] = {"path": str(args.trace),
                          "format": eng.dump_trace(args.trace)}
    return extra


def _serve_engine(cfg, params, prompts: np.ndarray, args
                  ) -> Tuple[Dict[int, List[int]], dict, float]:
    """Serve ``prompts`` through the legacy or the paged engine (or a
    fleet of paged engines).  Returns (streams by request id, the
    engine's metrics, wall seconds)."""
    max_seq = args.prompt_len + args.gen + 1
    if args.engine == "legacy":
        from repro_torch.core.serving import ServingEngine
        eng = ServingEngine(cfg, params, max_slots=args.batch,
                            max_seq=max_seq, device=args.device)
    else:
        eng = _paged(cfg, params, args, max_seq)
    t0 = time.time()
    ids = [eng.submit(row, args.gen) for row in prompts]
    results = eng.run_to_completion()
    _sync(torch.device(args.device))
    wall = time.time() - t0
    return ({rid: results[rid] for rid in ids},
            _finish(eng, args, eng.metrics()), wall)


def _serve_open_loop(cfg, params, args
                     ) -> Tuple[Dict[int, List[int]], dict, float]:
    """Serve the seeded open-loop workload through ``ServingFrontend`` on
    the wall clock.  Returns (streams by front-end id, the engine's
    metrics with the SLO scorecard under ``open_loop``, wall seconds)."""
    from repro_torch.serving import ServingFrontend
    from repro_torch.serving.loadgen import build_workload
    wl = build_workload(mix=args.mix, arrivals=args.arrivals,
                        n=args.requests, seed=args.seed, vocab=cfg.vocab,
                        rate=args.rate, trace=args.trace_file)
    cap = max(r.prompt.size + r.max_new_tokens for r in wl) + 1
    eng = _paged(cfg, params, args, cap)
    fe = ServingFrontend(eng)
    t0 = time.time()
    fids = fe.submit_workload(wl)
    fe.drain()
    _sync(torch.device(args.device))
    wall = time.time() - t0
    extra = eng.metrics()
    extra["open_loop"] = fe.report(slo_ttft_s=args.slo_ttft,
                                   slo_tpot_s=args.slo_tpot)
    extra["workload"] = {"mix": args.mix, "arrivals": args.arrivals,
                         "requests": len(wl), "seed": args.seed,
                         "rate_req_s": args.rate}
    return ({fid: fe.result(fid).tokens for fid in fids},
            _finish(eng, args, extra), wall)


if __name__ == "__main__":
    main()
