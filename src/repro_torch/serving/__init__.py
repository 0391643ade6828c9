"""Paged-KV serving in PyTorch (the counterpart of ``repro.serving``).

Components:
    blocks      — pooled fixed-size KV pages, ref-counted allocator, block
                  tables, host swap and spill tiers (a copy of
                  ``repro/serving/blocks.py``)
    paged_attn  — cache init + the per-tick unified step over the op
                  boundary in ``repro_torch.kernels.paged_attention``
    engine      — PagedServingEngine: unified ragged tick, token budget,
                  FCFS admission, recompute or swap preemption, prefix
                  cache with a host tier, speculative decoding
    scheduler   — FCFS admission, preemption policies, latency accounting
                  (a copy of ``repro/serving/scheduler.py``)
    speculative — the n-gram drafter (a copy of
                  ``repro/serving/speculative.py``)
    loadgen     — seeded open-loop workloads (Poisson / bursty / trace
                  arrivals x named request mixes) and the SLO scorecard
                  (a copy of ``repro/serving/loadgen.py``)
    frontend    — ServingFrontend: open-loop request server
                  (submit/stream/cancel/drain) whose host admission
                  overlaps the in-flight tick; VirtualClock
    router      — ReplicaRouter: N engines behind the engine contract,
                  prefix-affinity or round-robin placement, elastic resize
                  and replica failure with re-routing

The legacy dense-cache engine is ``repro_torch.core.serving.ServingEngine``.
"""
from repro_torch.serving.blocks import BlockAllocator, BlockTable
from repro_torch.serving.engine import PagedServingEngine
from repro_torch.serving.frontend import ServingFrontend, VirtualClock
from repro_torch.serving.router import ReplicaRouter
from repro_torch.serving.scheduler import FCFSScheduler, RequestStats
from repro_torch.serving.speculative import NGramDrafter

__all__ = ["BlockAllocator", "BlockTable", "FCFSScheduler", "NGramDrafter",
           "PagedServingEngine", "ReplicaRouter", "RequestStats",
           "ServingFrontend", "VirtualClock"]
