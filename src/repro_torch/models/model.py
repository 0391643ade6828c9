"""Model assembly for every family: init, forward, prefill and decode.
The counterpart of ``repro/models/model.py``.

    init_params(cfg, seed, device)        -> params (nested dict of tensors)
    forward(cfg, params, batch)           -> final hidden states (B, S, d)
    chunked_xent(cfg, params, hidden, labels) -> (sum nll, token count)
    loss_fn(cfg, params, batch)           -> (loss, metrics)
    prefill(cfg, params, batch)           -> last final hidden (B, 1, d)
    init_cache(cfg, batch, seq, device)   -> stacked decode cache
    prefill_cached(cfg, params, batch, cache) -> (hidden (B, S, d), cache)
    decode_step(cfg, params, cache, tokens, pos) -> (logits (B, 1, V), cache)

A batch holds ``tokens`` (and ``labels`` for the loss); an image-prefix
model (paligemma) also takes ``image_embeds`` (B, n_image_tokens, d),
projected and put before the text as a bidirectional prefix, and an
encoder-decoder (whisper) takes ``frames`` (B, encoder_seq, d), the
encoder's input (the audio front end is a stub, as in the JAX package).

A dense cache holds K and V for ``seq`` positions, plus the SSM state
(hymba) and the encoder's K and V for cross attention (whisper); an RWKV
cache is the constant-size recurrent state, whatever ``seq`` is.  Caches
are updated in place; the JAX package returns updated copies.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import rwkv6
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (_normal, apply_norm, compute_dtype,
                                       embed_tokens, init_embed, init_norm,
                                       logits_from_hidden, padded_vocab)
from repro_torch.models.transformer import (FULL_WINDOW, apply_stack,
                                            check_dense, init_stack,
                                            layer_windows)

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
    p["layers"] = init_stack(cfg, gen, cfg.n_layers, dev, dt,
                             cross=cfg.n_encoder_layers > 0)
    p["final_ln"] = init_norm(cfg, (cfg.d_model,), dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = {"kernel": _normal(
            gen, (cfg.d_model, padded_vocab(cfg.vocab)), cfg.d_model ** -0.5,
            dt, dev)}
    if cfg.rope_theta <= 0:  # learned absolute positions (whisper)
        p["pos_embed"] = {"table": _normal(
            gen, (max(cfg.max_seq, 2048), cfg.d_model), 0.02, dt, dev)}
    if cfg.n_encoder_layers:
        p["encoder"] = {
            "layers": init_stack(cfg, gen, cfg.n_encoder_layers, dev, dt),
            "final_ln": init_norm(cfg, (cfg.d_model,), dev),
            "pos_embed": {"table": _normal(
                gen, (cfg.encoder_seq, cfg.d_model), 0.02, dt, dev)},
        }
    if cfg.n_image_tokens:
        p["image_proj"] = {"kernel": _normal(
            gen, (cfg.d_model, cfg.d_model), cfg.d_model ** -0.5, dt, dev)}
    return p


def _layer_count(cfg, cross: bool) -> int:
    """Parameters of one layer of a stack (see ``init_stack``)."""
    d, f = cfg.d_model, cfg.d_ff
    norms = d * (2 if cfg.norm == "layernorm" else 1)
    if cfg.rwkv:
        inner, lora = cfg.q_dim, rwkv6.DECAY_LORA
        # mu, wr/wk/wv/wg, w0, w1, w2, u, ln_out, wo
        tm = (5 * d + 4 * d * inner + inner + d * lora + lora * inner
              + inner + 2 * inner + inner * d)
        return tm + 2 * d + 2 * d * f + 2 * norms
    attn = d * cfg.q_dim * 2 + d * cfg.kv_dim * 2
    mats = 3 if cfg.act in ("swiglu", "geglu") else 2
    if cfg.moe is not None:
        E = cfg.moe.num_experts
        ffn = d * E + E * d * cfg.moe.d_ff * mats
    else:
        ffn = d * f * mats
    layer = attn + ffn + 2 * norms
    if cross:
        layer += attn + norms
    if cfg.parallel_ssm:
        inner, N = cfg.q_dim, cfg.ssm_state
        # w_in, w_gate, w_out; w_dt, dt_bias; w_b, w_c, a_log; d_skip
        layer += (3 * d * inner + inner * inner + inner + 3 * inner * N
                  + inner + 2 * norms)
    return layer


def count_params(cfg) -> int:
    """Analytic parameter count of the parameter tree (no allocation)."""
    d = cfg.d_model
    norms = d * (2 if cfg.norm == "layernorm" else 1)
    embed = padded_vocab(cfg.vocab) * d
    total = (cfg.n_layers * _layer_count(cfg, cfg.n_encoder_layers > 0)
             + norms + embed + (0 if cfg.tie_embeddings else embed))
    if cfg.rope_theta <= 0:
        total += max(cfg.max_seq, 2048) * d
    if cfg.n_encoder_layers:
        total += (cfg.n_encoder_layers * _layer_count(cfg, False) + norms
                  + cfg.encoder_seq * d)
    if cfg.n_image_tokens:
        total += d * d
    return total


def check_trainable(cfg) -> None:
    """Raise for an MoE config: training it without the router's
    load-balancing term would silently train another model."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE training, with its load-balancing aux term "
            f"in the loss, is not ported yet (ROADMAP.md Queue 1 item 11)")


def _encode(cfg, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """The whisper encoder over precomputed frame embeddings (the front
    end is a stub): learned positions, a non-causal stack, a final
    norm."""
    enc = params["encoder"]
    x = frames.to(compute_dtype(cfg))
    x = x + enc["pos_embed"]["table"][None, :x.shape[1]].to(x.dtype)
    wins = np.full((cfg.n_encoder_layers,), FULL_WINDOW, np.int32)
    x, _ = apply_stack(enc["layers"], x, cfg,
                       positions=torch.arange(x.shape[1], device=x.device),
                       windows=wins, causal=False)
    return apply_norm(enc["final_ln"], x)


def _embed_inputs(cfg, params: Params, batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor, int,
                             Optional[torch.Tensor]]:
    """Returns (x (B, S, d), positions (S,), n_prefix, enc_out): the text
    embedded after the projected image prefix (when the config has one and
    the batch carries ``image_embeds``), learned positions added, and the
    encoder's output (whisper)."""
    x = embed_tokens(params["embed"], batch["tokens"], cfg)
    n_prefix = 0
    enc_out = None
    if cfg.n_image_tokens and "image_embeds" in batch:
        img = (batch["image_embeds"].to(x.dtype)
               @ params["image_proj"]["kernel"].to(x.dtype))
        x = torch.cat([img, x], dim=1)
        n_prefix = cfg.n_image_tokens
    if cfg.n_encoder_layers:
        enc_out = _encode(cfg, params, batch["frames"])
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.rope_theta <= 0:
        x = x + params["pos_embed"]["table"][None, :x.shape[1]].to(x.dtype)
    return x, positions, n_prefix, enc_out


def forward(cfg, params: Params, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Full-sequence forward; returns the final normed hidden (B, S, d),
    S counting the image prefix where there is one."""
    x, positions, n_prefix, enc_out = _embed_inputs(cfg, params, batch)
    x, _ = apply_stack(params["layers"], x, cfg, positions=positions,
                       windows=layer_windows(cfg), n_prefix=n_prefix,
                       enc_out=enc_out)
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
    """Mean next-token cross-entropy over labels >= 0, none on the image
    prefix (the families the port trains have no auxiliary loss).
    Returns (loss, {"loss", "xent", "aux", "tokens"}).  An MoE config
    raises: its loss needs the load-balancing aux term, which the port's
    forward does not carry yet."""
    check_trainable(cfg)
    hidden = forward(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
    labels = batch["labels"]
    if cfg.n_image_tokens and "image_embeds" in batch:
        pad = torch.full((labels.shape[0], cfg.n_image_tokens), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    tot, cnt = chunked_xent(cfg, params, hidden, labels)
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
    """Stacked decode cache by group: ``kv``, (L, B, seq, Hkv, D) K and V;
    ``ssm``, the (L, B, I, N) fp32 state (hymba); ``cross``, the encoder's
    (L, B, encoder_seq, Hkv, D) K and V and ``cross_filled`` (whisper); or
    ``rwkv``, the RWKV state, whose size does not depend on ``seq``."""
    dev = resolve_device(device)
    dt = dtype or compute_dtype(cfg)
    if cfg.rwkv:
        return {"rwkv": rwkv6.init_rwkv_state(cfg, batch, dt, dev)}
    L = cfg.n_layers
    shape = (L, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    cache: Params = {"kv": {"k": torch.zeros(shape, dtype=dt, device=dev),
                            "v": torch.zeros(shape, dtype=dt, device=dev)}}
    if cfg.parallel_ssm:
        cache["ssm"] = ssm_lib.init_ssm_state(cfg, batch, dev)
    if cfg.n_encoder_layers:
        shape = (L, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        cache["cross"] = {
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "cross_filled": torch.ones((L,), dtype=torch.float32,
                                       device=dev)}
    return cache


def prefill_cached(cfg, params: Params, batch: Dict[str, torch.Tensor],
                   cache: Params) -> Tuple[torch.Tensor, Params]:
    """Prefill that fills the decode cache from position 0 (the image
    prefix first, the encoder's K and V for cross attention, the SSM or
    RWKV state carried by the exact scan).  Returns the final normed
    hidden (B, S, d) and the cache."""
    x, positions, n_prefix, enc_out = _embed_inputs(cfg, params, batch)
    x, cache = apply_stack(params["layers"], x, cfg,
                           positions=positions.to(torch.int32),
                           windows=layer_windows(cfg), n_prefix=n_prefix,
                           enc_out=enc_out, caches=cache, cache_index=0)
    return apply_norm(params["final_ln"], x), cache


def decode_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
                pos: int) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1); pos: the cache fill level (the
    token's position, counting an image prefix).  Returns (logits (B, 1,
    V_padded), cache)."""
    x = embed_tokens(params["embed"], tokens, cfg)
    if cfg.rope_theta <= 0:
        x = x + params["pos_embed"]["table"][pos:pos + 1][None].to(x.dtype)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    x, cache = apply_stack(params["layers"], x, cfg, positions=positions,
                           windows=layer_windows(cfg), caches=cache,
                           cache_index=pos)
    x = apply_norm(params["final_ln"], x)
    return logits_from_hidden(params, x, cfg), cache
