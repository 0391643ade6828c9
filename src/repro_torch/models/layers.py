"""Shared transformer layers in PyTorch: norms, RoPE, attention, MLPs,
embeddings.  The counterpart of ``repro/models/layers.py``.

Parameters are plain dicts of tensors with the JAX package's tree and
layout: weights are ``(in, out)`` and layers compute ``x @ W``.  Stacked
layer weights carry a leading ``L`` axis (``models/transformer.py``).
For serving, matrices are stored in the compute dtype (``cfg.dtype``):
the JAX package keeps fp32 masters and casts them to that dtype at every
use, which gives the same values.  For training they are fp32 masters
(the init functions' ``dtype``, ``cfg.param_dtype``), cast at every use as
in the JAX package.  Norm scales stay fp32, as the norm computes in fp32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops

Params = Dict[str, Any]

# Large-negative constant used for masking (safe in bf16/f32).
NEG_INF = -1e9


def compute_dtype(cfg) -> torch.dtype:
    """The activation dtype a config names (``"bfloat16"``, ``"float32"``)."""
    return getattr(torch, cfg.dtype)


def _normal(gen: torch.Generator, shape, std: float, dtype: torch.dtype,
            device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg, shape, device) -> Params:
    p = {"scale": torch.ones(shape, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm (or layer norm when ``p`` has a bias), computed in fp32."""
    dtype = x.dtype
    x = x.float()
    if "bias" in p:  # layernorm
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        var = x.square().mean(-1, keepdim=True)
        y = x * torch.rsqrt(var + eps) * p["scale"]
    return y.to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, fraction: float, theta: float,
                     device=None) -> Tuple[torch.Tensor, int]:
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,).  Interleaved pairs:
    ``(x[..., 0::2], x[..., 1::2])`` rotate together, as in the JAX
    package (not the half-split layout)."""
    if theta <= 0.0:
        return x
    d = x.shape[-1]
    inv, rot = rope_frequencies(d, fraction, theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * inv               # (B, S, rot/2)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    rotated = torch.stack([out1, out2], dim=-1).reshape(
        x.shape[:-1] + (rot,))
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(cfg, gen: torch.Generator, n_layers: int, device,
                   dtype: Optional[torch.dtype] = None) -> Params:
    """``dtype``: of the matrices, the compute dtype by default."""
    d = cfg.d_model
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L = (n_layers,) if n_layers else ()
    std = d ** -0.5
    dt = dtype or compute_dtype(cfg)
    return {
        "wq": _normal(gen, L + (d, h * hd), std, dt, device),
        "wk": _normal(gen, L + (d, hkv * hd), std, dt, device),
        "wv": _normal(gen, L + (d, hkv * hd), std, dt, device),
        "wo": _normal(gen, L + (h * hd, d), (h * hd) ** -0.5, dt, device),
    }


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool, window: int, q_offset: int,
                       softcap: float, q_chunk: int = 512,
                       k_chunk: int = 1024, n_prefix: int = 0
                       ) -> torch.Tensor:
    """Online-softmax attention, never more than (B, H, q_chunk, k_chunk)
    scores at once.

    q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D).  Key j is visible to query i iff
    (not causal or j <= i) and (i - j < window), or both lie in the first
    ``n_prefix`` positions (a bidirectional prefix, paligemma's image
    tokens); ``q_offset`` shifts query positions.  As in the JAX package,
    q is scaled in its own dtype, dots accumulate in fp32 and p is rounded
    to v's dtype before the PV product.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qc = min(q_chunk, Sq)
    while Sq % qc:
        qc -= 1
    kc = min(k_chunk, Sk)
    while Sk % kc:
        kc -= 1
    q = (q * D ** -0.5).to(q.dtype)
    kexp = k.repeat_interleave(G, dim=2)
    vexp = v.repeat_interleave(G, dim=2)
    q_pos_all = q_offset + torch.arange(Sq, device=q.device)
    k_pos_all = torch.arange(Sk, device=q.device)
    outs = []
    for q0 in range(0, Sq, qc):
        qblk = q[:, q0:q0 + qc].float()
        q_pos = q_pos_all[q0:q0 + qc]
        m = torch.full((B, H, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, qc, D), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, Sk, kc):
            kblk = kexp[:, k0:k0 + kc]
            vblk = vexp[:, k0:k0 + kc]
            s = torch.einsum("bqhd,bkhd->bhqk", qblk, kblk.float())
            if softcap > 0.0:
                s = torch.tanh(s / softcap) * softcap
            dpos = q_pos[:, None] - k_pos_all[None, k0:k0 + kc]
            mask = dpos < window
            if causal:
                mask &= dpos >= 0
            if n_prefix > 0:
                mask |= ((q_pos[:, None] < n_prefix)
                         & (k_pos_all[None, k0:k0 + kc] < n_prefix))
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vblk.dtype).float(), vblk.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B, H, qc, D)
        outs.append(out.transpose(1, 2))
    return torch.cat(outs, dim=1).to(q.dtype)


def apply_cross_attention(p: Params, x: torch.Tensor, cfg, *,
                          enc_out: Optional[torch.Tensor] = None,
                          cache: Optional[Params] = None,
                          ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Encoder-decoder cross attention (whisper), no mask.

    Training and prefill: ``enc_out`` (B, Se, d) given, K and V computed
    from it (and written IN PLACE into ``cache``, this layer's ``{"k",
    "v", "cross_filled"}``, when one is given).  Decode: K and V read from
    the cache.  Returns (output, cache)."""
    B, Sq, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(B, Sq, h, hd)
    if enc_out is not None:
        Se = enc_out.shape[1]
        k = (enc_out @ p["wk"].to(x.dtype)).reshape(B, Se, hkv, hd)
        v = (enc_out @ p["wv"].to(x.dtype)).reshape(B, Se, hkv, hd)
        if cache is not None:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
            cache["cross_filled"].fill_(1)
    else:
        if cache is None:
            raise ValueError("cross attention needs enc_out or a cache")
        k, v = cache["k"], cache["v"]
    G = h // hkv
    kexp = k.repeat_interleave(G, dim=2).to(q.dtype)
    vexp = v.repeat_interleave(G, dim=2).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", (q * hd ** -0.5).float(),
                     kexp.float())
    prob = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", prob.to(vexp.dtype).float(),
                       vexp.float()).to(q.dtype)
    out = out.reshape(B, Sq, h * hd)
    return out @ p["wo"].to(x.dtype), cache


def apply_attention(p: Params, x: torch.Tensor, cfg, *,
                    positions: torch.Tensor, causal: bool = True,
                    window: Optional[int] = None,
                    cache: Optional[Params] = None,
                    cache_index: Optional[int] = None,
                    n_prefix: int = 0,
                    ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Self-attention with an optional dense KV cache; the first
    ``n_prefix`` positions see each other both ways (paligemma's image
    prefix).

    cache: {"k": (B, S, Hkv, D), "v": ...}, written IN PLACE at
    ``cache_index`` (the JAX package returns an updated copy).  Returns
    (output, cache).  Without a cache, ``cfg.use_pallas_attention`` on the
    unrolled stack (``scan_layers=False``) with no prefix, the JAX
    package's condition for its kernel, selects the flash-attention op,
    whose backend follows the tensors' device; anything else runs the
    chunked attention.
    """
    B, Sq, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(B, Sq, h, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, Sq, hkv, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, Sq, hkv, hd)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    softcap = cfg.attn_logit_softcap
    if cache is not None:
        idx = 0 if cache_index is None else int(cache_index)
        ck, cv = cache["k"], cache["v"]
        ck[:, idx:idx + Sq] = k.to(ck.dtype)
        cv[:, idx:idx + Sq] = v.to(cv.dtype)
        Sk = ck.shape[1]
        kexp = ck.repeat_interleave(h // hkv, dim=2)
        vexp = cv.repeat_interleave(h // hkv, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", (q * hd ** -0.5).float(),
                         kexp.float())
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        k_pos = torch.arange(Sk, device=x.device)
        q_pos = positions if positions.dim() == 1 else positions[0]
        valid = k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            valid &= (q_pos[:, None] - k_pos[None, :]) < window
        if n_prefix > 0:
            valid |= (q_pos[:, None] < n_prefix) & (k_pos[None, :] < n_prefix)
        s = torch.where(valid[None, None], s, NEG_INF)
        prob = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", prob.to(vexp.dtype).float(),
                           vexp.float()).to(q.dtype)
    elif cfg.use_pallas_attention and not cfg.scan_layers and n_prefix == 0:
        win = 0 if window is None or window >= (1 << 30) else window
        out = fa_ops.attention_trainable(q, k, v, causal=causal, window=win,
                                         softcap=softcap)
    else:
        out = _chunked_attention(
            q, k, v, causal=causal,
            window=(1 << 30) if window is None else window, q_offset=0,
            softcap=softcap, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
            n_prefix=n_prefix)
    out = out.reshape(B, Sq, h * hd)
    return out @ p["wo"].to(x.dtype), cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(cfg, gen: torch.Generator, n_layers: int, device,
             dtype: Optional[torch.dtype] = None) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    L = (n_layers,) if n_layers else ()
    dt = dtype or compute_dtype(cfg)
    p = {}
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = _normal(gen, L + (d, f), d ** -0.5, dt, device)
        p["wu"] = _normal(gen, L + (d, f), d ** -0.5, dt, device)
    else:
        p["wi"] = _normal(gen, L + (d, f), d ** -0.5, dt, device)
    p["wo"] = _normal(gen, L + (f, d), f ** -0.5, dt, device)
    return p


def apply_mlp(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    dt = x.dtype
    if act == "swiglu":
        h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wu"].to(dt))
    elif act == "geglu":
        h = F.gelu(x @ p["wg"].to(dt), approximate="tanh") \
            * (x @ p["wu"].to(dt))
    elif act == "relu_sq":
        h = torch.relu(x @ p["wi"].to(dt)).square()
    else:  # gelu
        h = F.gelu(x @ p["wi"].to(dt), approximate="tanh")
    return h @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# Embeddings / logits
# ---------------------------------------------------------------------------

def padded_vocab(vocab: int, multiple: int = 256) -> int:
    return (vocab + multiple - 1) // multiple * multiple


def init_embed(cfg, gen: torch.Generator, device,
               dtype: Optional[torch.dtype] = None) -> Params:
    V = padded_vocab(cfg.vocab)
    return {"table": _normal(gen, (V, cfg.d_model), 1.0,
                             dtype or compute_dtype(cfg), device)}


def embed_tokens(p: Params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    x = p["table"][tokens].to(compute_dtype(cfg))
    if cfg.family in ("dense", "vlm") and cfg.act == "geglu":
        # gemma-family scales embeddings by sqrt(d_model), in the compute
        # dtype (the scalar is rounded to it first, as in the JAX package)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def logits_from_hidden(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (..., d) -> (..., padded_vocab); padded columns masked to NEG_INF."""
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"]["kernel"].to(x.dtype)
    if cfg.logit_softcap > 0.0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    V, Vp = cfg.vocab, padded_vocab(cfg.vocab)
    if Vp != V:
        logits[..., V:] = NEG_INF
    return logits
