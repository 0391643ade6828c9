"""Model assembly for the dense and MoE decoders and the RWKV-6 family:
init, forward, prefill and decode.  The counterpart of
``repro/models/model.py``.

    init_params(cfg, seed, device)        -> params (nested dict of tensors)
    forward(cfg, params, batch)           -> final hidden states (B, S, d)
    chunked_xent(cfg, params, hidden, labels) -> (sum nll, token count)
    loss_fn(cfg, params, batch)           -> (loss, metrics)
    prefill(cfg, params, batch)           -> last final hidden (B, 1, d)
    init_cache(cfg, batch, seq, device)   -> stacked decode cache
    prefill_cached(cfg, params, batch, cache) -> (hidden (B, S, d), cache)
    decode_step(cfg, params, cache, tokens, pos) -> (logits (B, 1, V), cache)

A dense cache holds K and V for ``seq`` positions; an RWKV cache is the
constant-size recurrent state, whatever ``seq`` is.  Caches are updated in
place; the JAX package returns updated copies.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import rwkv6
from repro_torch.models.layers import (_normal, apply_norm, compute_dtype,
                                       embed_tokens, init_embed, init_norm,
                                       logits_from_hidden, padded_vocab)
from repro_torch.models.transformer import (apply_stack, check_dense,
                                            init_stack, layer_windows)

Params = Dict[str, Any]


def init_params(cfg, seed: int = 0, device: DeviceLike = None,
                param_dtype: Optional[torch.dtype] = None) -> Params:
    """Random weights with the JAX package's tree, shapes and init scales,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (the two frameworks draw different numbers from the same seed: tests
    that need identical weights go through ``repro_torch.weights``).
    Matrices are in ``param_dtype``: the compute dtype by default (serving),
    fp32 masters for training; both round the same fp32 draws."""
    check_dense(cfg)
    dev = resolve_device(device)
    dt = param_dtype or compute_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p: Params = {"embed": init_embed(cfg, gen, dev, dt)}
    p["layers"] = init_stack(cfg, gen, cfg.n_layers, dev, dt)
    p["final_ln"] = init_norm(cfg, (cfg.d_model,), dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = {"kernel": _normal(
            gen, (cfg.d_model, padded_vocab(cfg.vocab)), cfg.d_model ** -0.5,
            dt, dev)}
    return p


def count_params(cfg) -> int:
    """Analytic parameter count of the parameter tree (no allocation)."""
    d, L, f = cfg.d_model, cfg.n_layers, cfg.d_ff
    norms = d * (2 if cfg.norm == "layernorm" else 1)
    embed = padded_vocab(cfg.vocab) * d
    head = 0 if cfg.tie_embeddings else embed
    if cfg.rwkv:
        inner, lora = cfg.q_dim, rwkv6.DECAY_LORA
        # mu, wr/wk/wv/wg, w0, w1, w2, u, ln_out, wo
        tm = (5 * d + 4 * d * inner + inner + d * lora + lora * inner
              + inner + 2 * inner + inner * d)
        cm = 2 * d + 2 * d * f
        layer = tm + cm
    else:
        attn = d * cfg.q_dim * 2 + d * cfg.kv_dim * 2
        mats = 3 if cfg.act in ("swiglu", "geglu") else 2
        if cfg.moe is not None:
            E = cfg.moe.num_experts
            ffn = d * E + E * d * cfg.moe.d_ff * mats
        else:
            ffn = d * f * mats
        layer = attn + ffn
    return L * (layer + 2 * norms) + norms + embed + head


def check_trainable(cfg) -> None:
    """Raise for an MoE config: training it without the router's
    load-balancing term would silently train another model."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE training, with its load-balancing aux term "
            f"in the loss, is not ported yet (ROADMAP.md Queue 1 item 11)")


def forward(cfg, params: Params, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Full-sequence forward; returns the final normed hidden (B, S, d)."""
    x = embed_tokens(params["embed"], batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = apply_stack(params["layers"], x, cfg, positions=positions,
                       windows=layer_windows(cfg))
    return apply_norm(params["final_ln"], x)


def chunked_xent(cfg, params: Params, hidden: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 1024
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden: (B, S, d); labels: (B, S) with -1 = ignore.

    Returns (sum_loss, sum_count).  Over S-chunks, each under
    ``torch.utils.checkpoint`` (the JAX package's ``@jax.checkpoint``), so
    the (B, chunk, V) fp32 logits are never held for the backward.
    """
    S = hidden.shape[1]
    c = min(chunk, S)
    while S % c:
        c -= 1

    def chunk_nll(hblk, yblk):
        logits = logits_from_hidden(params, hblk, cfg).float()
        mask = yblk >= 0
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            torch.clamp(yblk, min=0)[..., None])[..., 0]
        return torch.where(mask, logz - gold, 0.0).sum(), mask.sum()

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for s0 in range(0, S, c):
        args = (hidden[:, s0:s0 + c], labels[:, s0:s0 + c])
        if torch.is_grad_enabled():
            nll, m = ckpt.checkpoint(chunk_nll, *args, use_reentrant=False)
        else:
            nll, m = chunk_nll(*args)
        tot = tot + nll
        cnt = cnt + m
    return tot, cnt


def loss_fn(cfg, params: Params, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean next-token cross-entropy over labels >= 0 (the dense and RWKV
    families have no auxiliary loss).  Returns (loss, {"loss", "xent",
    "aux", "tokens"}).  An MoE config raises: its loss needs the
    load-balancing aux term, which the port's forward does not carry
    yet."""
    check_trainable(cfg)
    hidden = forward(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
    tot, cnt = chunked_xent(cfg, params, hidden, batch["labels"])
    xent = tot / torch.clamp(cnt.float(), min=1.0)
    loss = xent + aux_weight * aux
    return loss, {"loss": loss, "xent": xent, "aux": aux, "tokens": cnt}


def prefill(cfg, params: Params, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Prefill forward with no cache write: the last position's final
    hidden (B, 1, d).  The compute-dominant part of serving a long prompt;
    with ``use_pallas_wkv`` an RWKV stack runs its recurrence in the wkv
    kernel here."""
    return forward(cfg, params, batch)[:, -1:]


def init_cache(cfg, batch: int, seq: int, device: DeviceLike = None,
               dtype=None) -> Params:
    """Stacked decode cache: (L, B, seq, Hkv, D) dense K and V, or the RWKV
    state ``{"rwkv": {tm_shift, wkv, cm_shift}}``, whose size does not
    depend on ``seq``."""
    dev = resolve_device(device)
    dt = dtype or compute_dtype(cfg)
    if cfg.rwkv:
        return {"rwkv": rwkv6.init_rwkv_state(cfg, batch, dt, dev)}
    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"kv": {"k": torch.zeros(shape, dtype=dt, device=dev),
                   "v": torch.zeros(shape, dtype=dt, device=dev)}}


def prefill_cached(cfg, params: Params, batch: Dict[str, torch.Tensor],
                   cache: Params) -> Tuple[torch.Tensor, Params]:
    """Prefill that fills the decode cache from position 0 (an RWKV stack
    runs the exact scan here, carrying its state).  Returns the final normed
    hidden (B, S, d) and the cache."""
    x = embed_tokens(params["embed"], batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device, dtype=torch.int32)
    x, cache = apply_stack(params["layers"], x, cfg, positions=positions,
                           windows=layer_windows(cfg), caches=cache,
                           cache_index=0)
    return apply_norm(params["final_ln"], x), cache


def decode_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
                pos: int) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1); pos: the cache fill level.
    Returns (logits (B, 1, V_padded), cache)."""
    x = embed_tokens(params["embed"], tokens, cfg)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    x, cache = apply_stack(params["layers"], x, cfg, positions=positions,
                           windows=layer_windows(cfg), caches=cache,
                           cache_index=pos)
    x = apply_norm(params["final_ln"], x)
    return logits_from_hidden(params, x, cfg), cache
