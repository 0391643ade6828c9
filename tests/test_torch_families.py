"""The port's hybrid-SSM, encoder-decoder and image-prefix families
(``repro_torch.models.ssm``, cross attention, the bidirectional prefix,
the model, ``generate``, the legacy engine and the CLI) against the JAX
package's, for reduced hymba-1.5b, whisper-small and paligemma-3b (2
layers, d 64, 4 heads of 16, fp32), on the same weights.

The JAX init leaves the SSM's ``dt_bias`` at zero, ``d_skip`` at one and
``a_log`` at log(1..N), which would hide a wrong use of any of them: the
fixture draws them into the numpy tree before both packages get it.  The
output projections of self attention, the SSM and the MLP are scaled by
``BRANCH_GAIN`` so that greedy streams vary (at random init the residual
stream is dominated by the token embedding, see
``tests/test_torch_paged_serving.py``), and paligemma's by sqrt(d) more,
as its embeddings are (gemma's scaling); cross attention adds the same
vector everywhere over zero frames, so scaled up it would set every token
alike.

Tolerances: the scan, the SSM branch, cross attention and the prefix mask
1e-5 of the largest reference value; logits 1e-4 of the largest (fp32,
two layers of sums in another order); greedy streams identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduced as jax_reduced
from repro.core.serving import ServingEngine as JaxServingEngine
from repro.launch.serve import generate as jax_generate
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch.config import get_config, reduced
from repro_torch.core.serving import ServingEngine
from repro_torch.launch.serve import generate, main
from repro_torch.models import layers as TL
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.layers import logits_from_hidden
from repro_torch.serving import PagedServingEngine
from repro_torch.weights import params_from_numpy

ARCHS = ("hymba-1.5b", "whisper-small", "paligemma-3b")
BRANCH_GAIN = 8.0
SSM_FP32 = ("w_dt", "dt_bias", "w_b", "w_c", "a_log", "d_skip")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def jax_tree(arch, gain=BRANCH_GAIN):
    """JAX's reduced init as numpy, the SSM's constants drawn and the
    output projections scaled."""
    jcfg = jax_reduced(jax_get_config(arch))
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    if jcfg.family == "vlm":
        gain *= jcfg.d_model ** 0.5
    rng = np.random.default_rng(3)
    stacks = [tree["layers"]] + ([tree["encoder"]["layers"]]
                                 if "encoder" in tree else [])
    for st in stacks:
        if "ssm" in st:
            s = st["ssm"]
            s["dt_bias"] = (rng.standard_normal(s["dt_bias"].shape)
                            * 0.5).astype(np.float32)
            s["d_skip"] = (1 + rng.standard_normal(s["d_skip"].shape)
                           * 0.1).astype(np.float32)
            s["a_log"] = (s["a_log"] + rng.standard_normal(
                s["a_log"].shape) * 0.1).astype(np.float32)
            s["w_out"] = s["w_out"] * gain
        for k in ("attn", "mlp"):
            st[k]["wo"] = st[k]["wo"] * gain
    return jcfg, tree


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, tree = jax_tree(arch)
    cfg = reduced(get_config(arch))
    params = params_from_numpy(tree, cfg, device="cpu")
    return arch, jcfg, jax.tree.map(jnp.asarray, tree), cfg, params


def _inputs(cfg, seed, B=2, S=12):
    """Tokens and, where the config takes them, image embeddings and
    audio frames, as numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.n_image_tokens:
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.n_encoder_layers:
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# --- the SSM branch ----------------------------------------------------------

@pytest.mark.parametrize("block", [1, 4])
def test_selective_scan_matches_jax(block):
    """y and the final state from a carried state, against JAX's scan at
    ``block`` 1 and 4 (one token a step in the port, whatever JAX's
    block)."""
    rng = np.random.default_rng(block)
    B, S, I, N = 2, 11, 24, 4
    u = rng.standard_normal((B, S, I)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, I)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((I, N)) * 0.3).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    h0 = rng.standard_normal((B, I, N)).astype(np.float32)
    wy, wh = jssm.selective_scan(*map(jnp.asarray, (u, dt, A, Bm, Cm)),
                                 state0=jnp.asarray(h0), block=block)
    gy, gh = ssm.selective_scan(*map(torch.from_numpy, (u, dt, A, Bm, Cm)),
                                state0=torch.from_numpy(h0))
    _close(gy.numpy(), wy)
    _close(gh.numpy(), wh)
    # no state: zeros, as JAX's
    wy, _ = jssm.selective_scan(*map(jnp.asarray, (u, dt, A, Bm, Cm)))
    gy, _ = ssm.selective_scan(*map(torch.from_numpy, (u, dt, A, Bm, Cm)))
    _close(gy.numpy(), wy)


@pytest.mark.parametrize("chunk,S", [(4, 23), (8, 8), (16, 300)])
def test_selective_scan_across_chunks(chunk, S, monkeypatch):
    """The port's associative scan over chunks of ``SCAN_CHUNK`` tokens
    (cut to 4, 8 and 16 here: several chunks, a ragged last one, exactly
    one, and 300 tokens with decays near 1) carries the state across
    chunk boundaries as JAX's sequential scan does."""
    monkeypatch.setattr(ssm, "SCAN_CHUNK", chunk)
    rng = np.random.default_rng(chunk)
    B, I, N = 2, 12, 4
    u = rng.standard_normal((B, S, I)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, I)))) * 0.1).astype(
        np.float32)
    A = -np.exp(rng.standard_normal((I, N)) * 0.3).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    h0 = rng.standard_normal((B, I, N)).astype(np.float32)
    wy, wh = jssm.selective_scan(*map(jnp.asarray, (u, dt, A, Bm, Cm)),
                                 state0=jnp.asarray(h0))
    gy, gh = ssm.selective_scan(*map(torch.from_numpy, (u, dt, A, Bm, Cm)),
                                state0=torch.from_numpy(h0))
    _close(gy.numpy(), wy)
    _close(gh.numpy(), wh)


@pytest.mark.parametrize("block", [1, 4])
def test_apply_ssm_matches_jax(block):
    """The branch of reduced hymba's layer 0 over 9 tokens, then one
    decode token carrying the state (written in place in the port)."""
    jcfg, tree = jax_tree("hymba-1.5b")
    jcfg = dataclasses.replace(jcfg, ssm_block=block)
    cfg = dataclasses.replace(reduced(get_config("hymba-1.5b")),
                              ssm_block=block)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["ssm"])
    tp = {k: torch.from_numpy(np.array(v[0]))
          for k, v in tree["layers"]["ssm"].items()}
    x = np.random.default_rng(9).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32)
    I = cfg.n_heads * cfg.head_dim
    want, _ = jssm.apply_ssm(jp, jnp.asarray(x[:, :9]), jcfg)
    got, none = ssm.apply_ssm(tp, torch.from_numpy(x[:, :9]), cfg)
    assert none is None
    _close(got.numpy(), want)
    jst = jnp.zeros((2, I, cfg.ssm_state))
    st = torch.zeros((2, I, cfg.ssm_state))
    _, jst = jssm.apply_ssm(jp, jnp.asarray(x[:, :9]), jcfg, state=jst)
    _, st2 = ssm.apply_ssm(tp, torch.from_numpy(x[:, :9]), cfg, state=st)
    assert st2 is st
    _close(st.numpy(), jst)
    want, jst = jssm.apply_ssm(jp, jnp.asarray(x[:, 9:]), jcfg, state=jst)
    got, _ = ssm.apply_ssm(tp, torch.from_numpy(x[:, 9:]), cfg, state=st)
    _close(got.numpy(), want)
    _close(st.numpy(), jst)


# --- cross attention and the prefix mask ------------------------------------

def test_cross_attention_matches_jax():
    """Reduced whisper's layer-0 cross attention (4 heads over 2): from
    the encoder output, filling a cache, then from the cache alone."""
    jcfg, tree = jax_tree("whisper-small")
    cfg = reduced(get_config("whisper-small"))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["cross"])
    tp = {k: torch.from_numpy(np.array(v[0]))
          for k, v in tree["layers"]["cross"].items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    shape = (2, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
          "cross_filled": jnp.zeros(())}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape),
          "cross_filled": torch.zeros(())}
    want, jc = JL.apply_cross_attention(jp, jnp.asarray(x), jcfg,
                                        enc_out=jnp.asarray(enc), cache=jc)
    got, tc2 = TL.apply_cross_attention(tp, torch.from_numpy(x), cfg,
                                        enc_out=torch.from_numpy(enc),
                                        cache=tc)
    assert tc2 is tc and float(tc["cross_filled"]) == 1.0
    _close(got.numpy(), want)
    _close(tc["k"].numpy(), jc["k"])
    _close(tc["v"].numpy(), jc["v"])
    want, _ = JL.apply_cross_attention(jp, jnp.asarray(x[:, :1]), jcfg,
                                       cache=jc)
    got, _ = TL.apply_cross_attention(tp, torch.from_numpy(x[:, :1]), cfg,
                                      cache=tc)
    _close(got.numpy(), want)
    with pytest.raises(ValueError):
        TL.apply_cross_attention(tp, torch.from_numpy(x), cfg)


@pytest.mark.parametrize("window,causal", [(1 << 30, True), (5, True),
                                           (1 << 30, False)])
def test_prefix_mask_matches_jax(window, causal):
    """The chunked attention with a 6-position bidirectional prefix over
    chunks that split it (q 4, k 8), and the dense-cache path with the
    prefix, against JAX's."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 16, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = JL._chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=jnp.asarray(window, jnp.int32), q_offset=0, softcap=0.0,
        q_chunk=4, k_chunk=8, n_prefix=6)
    got = TL._chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, q_offset=0, softcap=0.0, q_chunk=4,
        k_chunk=8, n_prefix=6)
    _close(got.numpy(), want)
    jcfg, tree = jax_tree("paligemma-3b")
    cfg = reduced(get_config("paligemma-3b"))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["attn"])
    tp = {n: torch.from_numpy(np.array(a[0]))
          for n, a in tree["layers"]["attn"].items()}
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    shape = (2, 14, cfg.n_kv_heads, cfg.head_dim)
    w = None if window >= (1 << 30) else window
    want, _ = JL.apply_attention(
        jp, jnp.asarray(x), jcfg, positions=jnp.arange(10), window=w,
        cache={"k": jnp.zeros(shape), "v": jnp.zeros(shape)},
        cache_index=jnp.asarray(0, jnp.int32), n_prefix=6)
    got, _ = TL.apply_attention(
        tp, torch.from_numpy(x), cfg, positions=torch.arange(10), window=w,
        cache={"k": torch.zeros(shape), "v": torch.zeros(shape)},
        cache_index=0, n_prefix=6)
    _close(got.numpy(), want)


def test_prefix_is_bidirectional_and_text_causal():
    """The port's twin of ``tests/test_models.py:67``: a change to the
    LAST image token moves the FIRST image position; a change to the last
    text token moves no earlier position."""
    cfg = reduced(get_config("paligemma-3b"))
    params = M.init_params(cfg, 0, "cpu")
    b = _t(_inputs(cfg, 1, S=16))
    n = cfg.n_image_tokens
    with torch.no_grad():
        h1 = M.forward(cfg, params, b)
        img = b["image_embeds"].clone()
        img[:, -1] += 10.0
        h2 = M.forward(cfg, params, dict(b, image_embeds=img))
        toks = b["tokens"].clone()
        toks[:, -1] = (toks[:, -1] + 1) % cfg.vocab
        h3 = M.forward(cfg, params, dict(b, tokens=toks))
    assert h1.shape == (2, n + 16, cfg.d_model)
    assert not torch.allclose(h1[:, 0], h2[:, 0])
    assert torch.equal(h1[:, :-1], h3[:, :-1])
    assert not torch.equal(h1[:, -1], h3[:, -1])


# --- the model ---------------------------------------------------------------

def test_forward_logits_match_jax(model):
    """``M.forward`` -> logits of the whole sequence (the image prefix
    included) within 1e-4 of JAX's ``M.forward``."""
    arch, jcfg, jp, cfg, params = model
    b = _inputs(cfg, 2)
    jh, _ = JM.forward(jcfg, jp, _j(b))
    want = np.asarray(JL.logits_from_hidden(jp, jh, jcfg))[..., :cfg.vocab]
    with torch.no_grad():
        got = logits_from_hidden(params, M.forward(cfg, params, _t(b)),
                                 cfg)[..., :cfg.vocab]
    assert got.shape == want.shape
    _close(got.numpy(), want, 1e-4)


def test_prefill_cached_and_decode_match_jax(model):
    """``prefill_cached`` into a cache, then three teacher-forced
    ``decode_step``s at the prefix-counting positions: logits, and the
    cache's K/V, SSM state and cross K/V, against JAX's."""
    arch, jcfg, jp, cfg, params = model
    b = _inputs(cfg, 3, S=9)
    n = cfg.n_image_tokens
    seq = n + 12
    jcache = JM.init_cache(jcfg, 2, seq)
    cache = M.init_cache(cfg, 2, seq, device="cpu")
    assert set(cache) == set(jcache)
    pre = {k: v for k, v in b.items()}
    pre["tokens"] = b["tokens"][:, :6]
    jh, jcache = JM.prefill_cached(jcfg, jp, _j(pre), jcache)
    with torch.no_grad():
        h, cache = M.prefill_cached(cfg, params, _t(pre), cache)
    _close(h.numpy(), jh, 1e-4)
    for i in range(6, 9):
        tok = b["tokens"][:, i:i + 1]
        pos = n + i
        want, jcache = JM.decode_step(jcfg, jp, jcache, jnp.asarray(tok),
                                      jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            got, cache = M.decode_step(cfg, params, cache,
                                       torch.from_numpy(tok), pos)
        _close(got[..., :cfg.vocab].numpy(),
               np.asarray(want)[..., :cfg.vocab], 1e-4)
    for group in cache:
        leaves = cache[group] if isinstance(cache[group], dict) \
            else {"": cache[group]}
        jleaves = jcache[group] if isinstance(jcache[group], dict) \
            else {"": jcache[group]}
        for name, t in leaves.items():
            _close(t.numpy(), jleaves[name], 1e-4)


def test_generate_matches_jax(model):
    """Greedy ``generate`` token-identical to JAX's greedy decoding with a
    cache that holds the image prefix, and to JAX's ``generate`` itself
    wherever that one's cache holds the sequence (hymba and whisper: all
    of it; paligemma: until its decode writes run past the end)."""
    arch, jcfg, jp, cfg, params = model
    toks = _inputs(cfg, 4, S=7)["tokens"]
    G, n = 12, cfg.n_image_tokens
    cache = JM.init_cache(jcfg, 2, n + 7 + G)
    batch = {"tokens": jnp.asarray(toks)}
    if n:
        batch["image_embeds"] = jnp.zeros((2, n, cfg.d_model))
    if cfg.n_encoder_layers:
        batch["frames"] = jnp.zeros((2, cfg.encoder_seq, cfg.d_model))
    h, cache = JM.prefill_cached(jcfg, jp, batch, cache)
    logits = JL.logits_from_hidden(jp, h[:, -1:], jcfg)
    want = [toks]
    for i in range(G):
        nxt = np.asarray(jnp.argmax(logits[:, -1], -1))[:, None]
        want.append(nxt.astype(np.int32))
        logits, cache = JM.decode_step(
            jcfg, jp, cache, jnp.asarray(nxt, jnp.int32),
            jnp.asarray(n + 7 + i, jnp.int32))
    want = np.concatenate(want, 1)
    got = generate(cfg, params, torch.from_numpy(toks), G).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:, 7:].ravel().tolist())) > 2   # streams vary
    clamp_free = 7 + (G if not n else G - n + 1)
    np.testing.assert_array_equal(
        got[:, :clamp_free],
        np.asarray(jax_generate(jcfg, jp, jnp.asarray(toks), G))[
            :, :clamp_free])


def test_jax_generate_cache_misses_the_prefix():
    """The reference fault the port avoids: JAX's ``generate`` sizes its
    cache for the text alone, so a generation shorter than the image
    prefix cannot even prefill; the port's cache holds the prefix."""
    jcfg, tree = jax_tree("paligemma-3b")
    cfg = reduced(get_config("paligemma-3b"))
    toks = _inputs(cfg, 5, S=6)["tokens"]
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jax_generate(jcfg, jax.tree.map(jnp.asarray, tree),
                     jnp.asarray(toks), cfg.n_image_tokens - 2)
    got = generate(cfg, params_from_numpy(tree, cfg, device="cpu"),
                   torch.from_numpy(toks), cfg.n_image_tokens - 2)
    assert got.shape == (2, 6 + cfg.n_image_tokens - 2)


def test_count_params_matches_jax():
    """The analytic count equals JAX's tree size, reduced and at full
    width (JAX's through ``eval_shape``: nothing allocated)."""
    for arch in ARCHS:
        for red in (True, False):
            jcfg, cfg = jax_get_config(arch), get_config(arch)
            if red:
                jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
            assert M.count_params(cfg) == JM.count_params_analytic(jcfg), \
                (arch, red)


def test_bridge_and_init_trees(model):
    """``init_params`` builds JAX's tree, shapes included;
    ``params_from_numpy`` carries it with the SSM's leaves fp32 under a
    bf16 compute dtype."""
    arch, jcfg, jp, cfg, params = model
    own = M.init_params(cfg, 0, "cpu")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}

    assert shapes(own) == shapes(jax.tree.map(np.asarray, jp))
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jp)
    p16 = params_from_numpy(tree, cfg16, device="cpu")
    own16 = M.init_params(cfg16, 0, "cpu")
    for p in (p16, own16):
        assert p["layers"]["attn"]["wq"].dtype == torch.bfloat16
        if cfg.parallel_ssm:
            for name in SSM_FP32:
                assert p["layers"]["ssm"][name].dtype == torch.float32, name
            assert p["layers"]["ssm"]["w_in"].dtype == torch.bfloat16


# --- serving -----------------------------------------------------------------

def test_legacy_engine_serves_hymba():
    """hymba through the legacy engine (2 slots, 3 requests, so a slot is
    reused) equals ``generate`` and the JAX engine's streams; the SSM
    state is one more cache group, zeroed when a request takes a slot
    (the JAX engine leaves the previous request's state there, which has
    decayed away within these prompts)."""
    arch = "hymba-1.5b"
    jcfg, tree = jax_tree(arch)
    cfg = reduced(get_config(arch))
    params = params_from_numpy(tree, cfg, device="cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, (s,)).astype(np.int32)
               for s in (5, 8, 6)]
    eng = ServingEngine(cfg, params, max_slots=2, max_seq=24, device="cpu")
    assert "ssm" in eng.cache
    ids = [eng.submit(p, 7) for p in prompts]
    out = eng.run_to_completion()
    jeng = JaxServingEngine(jcfg, jax.tree.map(jnp.asarray, tree),
                            max_slots=2, max_seq=24)
    jids = [jeng.submit(p, 7) for p in prompts]
    jout = jeng.run_to_completion()
    for rid, jid, p in zip(ids, jids, prompts):
        want = generate(cfg, params, torch.from_numpy(p)[None], 7)[0, len(p):]
        assert out[rid] == want.tolist()
        assert jout[jid] == out[rid]
    eng.cache["ssm"].fill_(1.0)
    eng._reset_state(1)
    assert (eng.cache["ssm"][:, 1] == 0).all()
    assert (eng.cache["ssm"][:, 0] == 1).all()


@pytest.mark.parametrize("arch", ["whisper-small", "paligemma-3b"])
def test_legacy_engine_refuses_encoder_and_prefix(arch):
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        ServingEngine(cfg, params, max_slots=2, max_seq=16, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_refuses(arch):
    """As JAX's ``paged_attn.supports``: no SSM, encoder or prefix."""
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="pure-attention"):
        PagedServingEngine(cfg, params, max_slots=2, block_size=4,
                           device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli(arch, capsys):
    """``--engine batch`` serves each family from the CLI (its report as
    for the other archs); ``--engine legacy`` serves hymba and refuses the
    other two; ``--engine paged`` refuses all three."""
    base = ["--reduced", "--device", "cpu", "--arch", arch, "--batch", "2",
            "--prompt-len", "5", "--gen", "4"]
    report = main(["--engine", "batch"] + base)
    assert report["output_shape"] == [2, 9] and report["device"] == "cpu"
    if arch == "hymba-1.5b":
        report = main(["--engine", "legacy"] + base)
        assert report["tick"] == "slot" and report["output_shape"] == [2]
    else:
        with pytest.raises(ValueError):
            main(["--engine", "legacy"] + base)
    with pytest.raises(ValueError):
        main(["--engine", "paged"] + base)
    capsys.readouterr()


def test_rwkv_with_another_family_still_raises():
    """``check_dense`` admits every family the JAX package defines and
    still refuses an RWKV-6 stack with an SSM branch, an encoder or an
    image prefix, which the JAX package builds none of."""
    base = reduced(get_config("rwkv6-1.6b"))
    for change in (dict(parallel_ssm=True, ssm_state=4),
                   dict(n_encoder_layers=2, encoder_seq=8),
                   dict(n_image_tokens=4)):
        cfg = dataclasses.replace(base, **change)
        with pytest.raises(NotImplementedError, match="RWKV-6"):
            M.init_params(cfg, 0, "cpu")
        with pytest.raises(NotImplementedError, match="RWKV-6"):
            params_from_numpy({}, cfg, device="cpu")
