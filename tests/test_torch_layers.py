"""The port's layers (``repro_torch.models.layers``) against the JAX
package's (``repro.models.layers``) on the same numpy inputs, in fp32.

Tolerance: 1e-5 relative (absolute part scaled by the reference's largest
magnitude).  Both sides compute in fp32; they differ only in the order of
sums and in the last ulp of transcendental functions.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduced as jax_reduced
from repro.models import layers as JL
from repro_torch.config import get_config, reduced
from repro_torch.models import layers as TL

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cfgs(arch, **kw):
    return (jax_reduced(jax_get_config(arch), **kw),
            reduced(get_config(arch), **kw))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm(kind):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 64) * 3.0
    p = {"scale": _rand(rng, 64)}
    if kind == "layernorm":
        p["bias"] = _rand(rng, 64)
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_with_padded_positions(fraction):
    """Interleaved-pair RoPE, positions -1 (padded rows) included."""
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 6, 4, 16)
    pos = np.array([[0, 1, 2, 3, -1, -1], [7, 8, 30, 31, 32, -1]], np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0,
                         fraction)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        10_000.0, fraction)
    _close(got, want)


@pytest.mark.parametrize("act", ["geglu", "swiglu"])
def test_mlp(act):
    rng = np.random.default_rng(2)
    x = _rand(rng, 3, 4, 64)
    p = {"wg": _rand(rng, 64, 128) / 8, "wu": _rand(rng, 64, 128) / 8,
         "wo": _rand(rng, 128, 64) / 11}
    want = JL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act)
    got = TL.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), act)
    _close(got, want)


@pytest.mark.parametrize("arch", ["gemma-2b", "granite-3-2b"])
def test_embed_tokens(arch):
    """gemma scales embeddings by sqrt(d_model); granite does not."""
    jcfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(3)
    table = _rand(rng, TL.padded_vocab(cfg.vocab), cfg.d_model)
    toks = rng.integers(0, cfg.vocab, (2, 7)).astype(np.int32)
    want = JL.embed_tokens({"table": jnp.asarray(table)}, jnp.asarray(toks),
                           jcfg)
    got = TL.embed_tokens({"table": torch.from_numpy(table)},
                          torch.from_numpy(toks), cfg)
    _close(got, want)
    scale = np.sqrt(cfg.d_model) if arch == "gemma-2b" else 1.0
    np.testing.assert_allclose(got.numpy(), table[toks] * scale, rtol=1e-6)


@pytest.mark.parametrize("arch", ["gemma-2b", "granite-3-2b"])
def test_logits_mask_padded_vocab(arch):
    jcfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(4)
    Vp = TL.padded_vocab(cfg.vocab)
    table = _rand(rng, Vp, cfg.d_model)
    x = _rand(rng, 2, 3, cfg.d_model)
    want = JL.logits_from_hidden({"embed": {"table": jnp.asarray(table)}},
                                 jnp.asarray(x), jcfg)
    got = TL.logits_from_hidden({"embed": {"table": torch.from_numpy(table)}},
                                torch.from_numpy(x), cfg)
    assert Vp > cfg.vocab and got.shape[-1] == Vp
    assert (got[..., cfg.vocab:] == TL.NEG_INF).all()
    _close(got[..., :cfg.vocab], np.asarray(want)[..., :cfg.vocab])


@pytest.mark.parametrize("window,softcap,G", [
    (1 << 30, 0.0, 2), (5, 0.0, 1), (4, 30.0, 4)])
def test_chunked_attention(window, softcap, G):
    """The dense path's online softmax over several q and k chunks."""
    rng = np.random.default_rng(5)
    B, S, Hkv, D = 2, 12, 2, 16
    q = _rand(rng, B, S, Hkv * G, D)
    k = _rand(rng, B, S, Hkv, D)
    v = _rand(rng, B, S, Hkv, D)
    want = JL._chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=jnp.asarray(window, jnp.int32), q_offset=0, softcap=softcap,
        q_chunk=4, k_chunk=6)
    got = TL._chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, q_offset=0, softcap=softcap, q_chunk=4,
        k_chunk=6)
    _close(got, want)


def test_apply_attention_dense_cache_decode():
    """The dense-cache branch ``generate`` decodes through: one query at
    position 5 against a filled cache, sliding window 4, GQA 2."""
    jcfg, cfg = _cfgs("granite-3-2b")
    jcfg = dataclasses.replace(jcfg, attn_logit_softcap=20.0)
    cfg = dataclasses.replace(cfg, attn_logit_softcap=20.0)
    rng = np.random.default_rng(6)
    d, hd = cfg.d_model, cfg.head_dim
    p = {"wq": _rand(rng, d, cfg.n_heads * hd) / 8,
         "wk": _rand(rng, d, cfg.n_kv_heads * hd) / 8,
         "wv": _rand(rng, d, cfg.n_kv_heads * hd) / 8,
         "wo": _rand(rng, cfg.n_heads * hd, d) / 8}
    x = _rand(rng, 2, 1, d)
    ck = _rand(rng, 2, 8, cfg.n_kv_heads, hd)
    cv = _rand(rng, 2, 8, cfg.n_kv_heads, hd)
    want, wcache = JL.apply_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
        positions=jnp.asarray([5], jnp.int32),
        window=jnp.asarray(4, jnp.int32),
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        cache_index=jnp.asarray(5, jnp.int32))
    tcache = {"k": torch.from_numpy(ck.copy()),
              "v": torch.from_numpy(cv.copy())}
    got, _ = TL.apply_attention(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        cfg, positions=torch.tensor([5], dtype=torch.int32), window=4,
        cache=tcache, cache_index=5)
    _close(got, want)
    _close(tcache["k"], wcache["k"])
