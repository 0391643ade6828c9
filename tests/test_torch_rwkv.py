"""The port's RWKV-6 family (``repro_torch.models.rwkv6``, the RWKV stack,
model, weight bridge, prefill and decode steps and the ``--engine batch``
CLI) against the JAX package's, for reduced rwkv6-1.6b (2 layers, d 64, 4
heads of 16, fp32), on the same weights.

The JAX init sets the bonus ``u`` to zeros, which would hide a wrong bonus
term: the fixture draws ``u`` (normal x 0.1) into the numpy tree before
both packages get it.

Tolerances: time mix, channel mix, one layer, the stack's hidden states,
logits and the decode state 1e-4 of the largest reference value (fp32, two
layers of sums in another order); greedy streams identical; parameter
counts and the state's size exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MoEConfig as JMoEConfig
from repro.config import get_config as jax_get_config
from repro.config import reduced as jax_reduced
from repro.launch.serve import generate as jax_generate
from repro.models import model as JM
from repro.models import rwkv6 as jrwkv
from repro.models import transformer as JT
from repro.models.layers import logits_from_hidden as jax_logits
from repro_torch.config import MoEConfig, get_config, reduced
from repro_torch.launch.serve import generate, main
from repro_torch.models import model as M
from repro_torch.models import rwkv6
from repro_torch.models import transformer as T
from repro_torch.models.layers import logits_from_hidden
from repro_torch.train.steps import make_decode_step, make_prefill_step
from repro_torch.weights import params_from_numpy

ARCH = "rwkv6-1.6b"
FP32_LEAVES = ("scale", "bias", "mu", "w0", "w1", "w2", "u")
SSM_FP32 = ("w_dt", "dt_bias", "w_b", "w_c", "a_log", "d_skip")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    u = tree["layers"]["rwkv"]["tm"]["u"]
    tree["layers"]["rwkv"]["tm"]["u"] = (
        np.random.default_rng(7).standard_normal(u.shape) * 0.1
    ).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    return jcfg, jp, tree, cfg, params_from_numpy(tree, cfg, device="cpu")


def _close(got, want, rel=1e-4):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _np(t):
    return t.detach().float().numpy()


def _x(seed, B, S, d):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def _tokens(seed, cfg, B, S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


def _layer(jp, params, cfg, i=0):
    return (jax.tree.map(lambda a: a[i], jp["layers"]),
            T.unstack(params["layers"], cfg.n_layers)[i])


def _state(seed, B, cfg):
    rng = np.random.default_rng(seed)
    H, D, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    return {"shift": rng.standard_normal((B, 1, d)).astype(np.float32),
            "wkv": rng.standard_normal((B, H, D, D)).astype(np.float32)}


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "state"])
def test_time_mix_matches_jax(model, carried):
    """Output, and with a carried state the new shift and wkv state."""
    jcfg, jp, _, cfg, params = model
    jl, tl = _layer(jp, params, cfg)
    x = _x(1, 2, 9, cfg.d_model)
    st = _state(2, 2, cfg) if carried else None
    jout, jst = jrwkv.apply_time_mix(
        jl["rwkv"]["tm"], jnp.asarray(x), jcfg,
        state=None if st is None else jax.tree.map(jnp.asarray, st))
    out, tst = rwkv6.apply_time_mix(
        tl["rwkv"]["tm"], torch.from_numpy(x), cfg,
        state=None if st is None else {k: torch.from_numpy(v)
                                       for k, v in st.items()})
    _close(_np(out), jout)
    assert (tst is None) == (jst is None)
    if carried:
        _close(_np(tst["shift"]), jst["shift"])
        _close(_np(tst["wkv"]), jst["wkv"])


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "state"])
def test_channel_mix_matches_jax(model, carried):
    jcfg, jp, _, cfg, params = model
    jl, tl = _layer(jp, params, cfg, 1)
    x = _x(3, 2, 9, cfg.d_model)
    st = _state(4, 2, cfg)["shift"] if carried else None
    jout, jst = jrwkv.apply_channel_mix(
        jl["rwkv"]["cm"], jnp.asarray(x), jcfg,
        state=None if st is None else {"shift": jnp.asarray(st)})
    out, tst = rwkv6.apply_channel_mix(
        tl["rwkv"]["cm"], torch.from_numpy(x), cfg,
        state=None if st is None else {"shift": torch.from_numpy(st)})
    _close(_np(out), jout)
    if carried:
        _close(_np(tst["shift"]), jst["shift"])


@pytest.mark.parametrize("pallas", [False, True], ids=["scan", "wkv_op"])
def test_one_layer_matches_jax(model, pallas):
    jcfg, jp, _, cfg, params = model
    jcfg = dataclasses.replace(jcfg, use_pallas_wkv=pallas)
    cfg = dataclasses.replace(cfg, use_pallas_wkv=pallas)
    jl, tl = _layer(jp, params, cfg)
    x = _x(5, 2, 11, cfg.d_model)
    want, _, _ = JT.layer_body(jl, jnp.asarray(x), jcfg,
                               positions=jnp.arange(11), window=1 << 30)
    got = T.layer_body(tl, torch.from_numpy(x), cfg,
                       positions=torch.arange(11), window=1 << 30)
    _close(_np(got), want)


@pytest.mark.parametrize("pallas", [False, True], ids=["scan", "wkv_op"])
def test_forward_and_prefill_match_jax(model, pallas):
    """``forward``, ``prefill`` and ``make_prefill_step`` with
    ``use_pallas_wkv`` off (the exact scan) and on (the wkv op: the plain
    version on CPU tensors; JAX's Pallas kernel in interpret mode)."""
    jcfg, jp, _, cfg, params = model
    jcfg = dataclasses.replace(jcfg, use_pallas_wkv=pallas)
    cfg = dataclasses.replace(cfg, use_pallas_wkv=pallas)
    toks = _tokens(6, cfg, 2, 16)
    jh, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    jlast = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        h = M.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
        last = M.prefill(cfg, params, {"tokens": torch.from_numpy(toks)})
    step = make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(toks)})
    _close(_np(h), jh)
    _close(_np(last), jlast)
    assert torch.equal(step, last) and step.shape == (2, 1, cfg.d_model)
    _close(_np(logits_from_hidden(params, h, cfg))[..., :cfg.vocab],
           np.asarray(jax_logits(jp, jh, jcfg))[..., :cfg.vocab])


def test_prefill_cached_and_decode_match_jax(model):
    """The stateful path: ``prefill_cached`` then teacher-forced
    ``decode_step`` (through ``make_decode_step``): hidden states, logits
    at every step and the final state of every layer."""
    jcfg, jp, _, cfg, params = model
    toks = _tokens(8, cfg, 2, 12)
    P = 7
    jcache = JM.init_cache(jcfg, 2, 12)
    jh, jcache = JM.prefill_cached(jcfg, jp, {"tokens": jnp.asarray(
        toks[:, :P])}, jcache)
    cache = M.init_cache(cfg, 2, 12, device="cpu")
    with torch.no_grad():
        h, cache = M.prefill_cached(cfg, params, {"tokens": torch.from_numpy(
            toks[:, :P])}, cache)
    _close(_np(h), jh)
    decode = make_decode_step(cfg)
    for pos in range(P, 12):
        jl, jcache = JM.decode_step(jcfg, jp, jcache,
                                    jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.asarray(pos, jnp.int32))
        lg, cache = decode(params, cache,
                           torch.from_numpy(toks[:, pos:pos + 1]), pos)
        _close(_np(lg)[..., :cfg.vocab], np.asarray(jl)[..., :cfg.vocab])
    for name in ("tm_shift", "wkv", "cm_shift"):
        _close(_np(cache["rwkv"][name]), jcache["rwkv"][name])


def test_generate_token_equal_to_jax(model):
    """Greedy streams of the port's ``generate`` equal JAX's ``generate``
    token for token."""
    jcfg, jp, _, cfg, params = model
    prompts = _tokens(9, cfg, 3, 9)
    want = np.asarray(jax_generate(jcfg, jp, jnp.asarray(prompts), 8))
    got = generate(cfg, params, torch.from_numpy(prompts), 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rwkv_state_decode_is_constant_memory(model):
    """The port of the JAX test of that name: the decode state does not
    grow with the sequence, before or after a prefill."""
    _, _, _, cfg, params = model

    def nbytes(cache):
        return sum(t.numel() * t.element_size()
                   for t in cache["rwkv"].values())

    c1 = M.init_cache(cfg, 2, 100, device="cpu")
    c2 = M.init_cache(cfg, 2, 100000, device="cpu")
    assert nbytes(c1) == nbytes(c2)
    H, D, d, L = cfg.n_heads, cfg.head_dim, cfg.d_model, cfg.n_layers
    assert nbytes(c1) == 2 * L * (H * D * D * 4 + 2 * d * 4)
    with torch.no_grad():
        for S in (3, 40):
            c = M.init_cache(cfg, 2, S, device="cpu")
            _, c = M.prefill_cached(cfg, params, {"tokens": torch.from_numpy(
                _tokens(S, cfg, 2, S))}, c)
            assert nbytes(c) == nbytes(c1)
            assert c["rwkv"]["wkv"].abs().sum() > 0


@pytest.mark.parametrize("over", [{}, dict(d_model=96, n_layers=3, d_ff=80,
                                           n_heads=2, head_dim=32,
                                           vocab=1000)],
                         ids=["reduced", "wider"])
def test_count_params_matches_jax(model, over):
    jcfg = jax_reduced(jax_get_config(ARCH), **over)
    cfg = reduced(get_config(ARCH), **over)
    assert M.count_params(cfg) == JM.count_params_analytic(jcfg)
    assert M.count_params(cfg) == sum(
        t.numel() for t in _leaves(M.init_params(cfg, 0, "cpu")))
    full = get_config(ARCH)
    assert abs(full.param_count() - 1.6e9) / 1.6e9 < 0.45


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield v


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_bridge_keeps_fp32_leaves_at_bf16(model):
    """At ``param_dtype=bfloat16`` the matrices are bf16 and the norms,
    token-shift coefficients, decay and bonus stay fp32, in the bridge and
    in the port's own init; the values are the tree's."""
    _, _, tree, cfg, _ = model
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16",
                                param_dtype="bfloat16")
    for params in (params_from_numpy(tree, cfg16, device="cpu"),
                   M.init_params(cfg16, 0, "cpu")):
        for name, t in _named(params):
            leaf = name.rsplit("/", 1)[-1]
            want = torch.float32 if leaf in FP32_LEAVES else torch.bfloat16
            assert t.dtype == want, name
    bridged = dict(_named(params_from_numpy(tree, cfg16, device="cpu")))
    np.testing.assert_array_equal(
        bridged["layers/rwkv/tm/w1"].numpy(),
        tree["layers"]["rwkv"]["tm"]["w1"])
    f32 = params_from_numpy(tree, cfg16, device="cpu",
                            param_dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in _leaves(f32))


def test_serve_cli_batch_engine(model, capsys):
    """``--engine batch`` on the CPU: the JAX batch report's keys plus the
    device; paged-engine knobs are refused; the paged engine refuses RWKV."""
    report = main(["--engine", "batch", "--reduced", "--device", "cpu",
                   "--arch", ARCH, "--batch", "2", "--prompt-len", "5",
                   "--gen", "4"])
    assert set(report) == {"arch", "engine", "batch", "prompt_len",
                           "generated", "device", "wall_s", "tokens_per_s",
                           "output_shape"}
    assert report["engine"] == "batch" and report["device"] == "cpu"
    assert report["output_shape"] == [2, 9]
    with pytest.raises(SystemExit):
        main(["--engine", "batch", "--reduced", "--device", "cpu",
              "--arch", ARCH, "--kv-dtype", "int8"])
    with pytest.raises(ValueError):
        main(["--engine", "paged", "--reduced", "--device", "cpu",
              "--arch", ARCH])
    capsys.readouterr()


def _flat(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("change", [
    dict(family="moe", moe=MoEConfig(num_experts=4, top_k=2, d_ff=64)),
    dict(family="hybrid", parallel_ssm=True), dict(n_encoder_layers=2),
    dict(family="vlm", n_image_tokens=4), dict(rope_theta=0.0)],
    ids=["moe", "hybrid_ssm", "encdec", "image_prefix", "learned_pos"])
def test_other_families_still_raise(change):
    """Every family change is admitted now (the MoE, hybrid-SSM,
    encoder-decoder, image-prefix and learned-position families are
    ported): ``init_params`` builds the family's leaves,
    and ``params_from_numpy`` carries JAX's reduced tree unchanged, the
    MoE router and the SSM's fp32 leaves fp32 under a bf16 compute
    dtype."""
    cfg = reduced(get_config("granite-3-2b"), **change)
    if cfg.moe is None:
        family = (("layers", "ssm") if cfg.parallel_ssm else
                  ("encoder",) if cfg.n_encoder_layers else
                  ("image_proj",) if cfg.n_image_tokens else ("pos_embed",))
        own = M.init_params(cfg, 0, "cpu")
        tree = jax.tree.map(np.asarray, JM.init_params(
            jax_reduced(jax_get_config("granite-3-2b"), **change),
            jax.random.PRNGKey(0)))
        got = params_from_numpy(tree, cfg, device="cpu")
        got16 = params_from_numpy(
            tree, dataclasses.replace(cfg, dtype="bfloat16"), device="cpu")
        flat = {"/".join(k): v for k, v in _flat(tree)}
        assert {"/".join(k) for k, _ in _flat(own)} == set(flat)
        assert any(tuple(k.split("/")[:len(family)]) == family
                   for k in flat), family
        for (path, t), (_, t16) in zip(_flat(got), _flat(got16)):
            name = "/".join(path)
            assert tuple(t.shape) == flat[name].shape, name
            np.testing.assert_array_equal(t.numpy(), flat[name],
                                          err_msg=name)
            fp32 = path[-1] in FP32_LEAVES + SSM_FP32
            assert t16.dtype == (torch.float32 if fp32 else torch.bfloat16)
        if cfg.parallel_ssm:
            assert set(own["layers"]["ssm"]) == set(SSM_FP32) | {
                "w_in", "w_gate", "w_out"}
        if cfg.n_encoder_layers:
            assert set(own["layers"]) >= {"cross", "ln_cross"}
        return
    own = M.init_params(cfg, 0, "cpu")["layers"]
    assert "mlp" not in own and set(own["moe"]) == {"router", "wg", "wu",
                                                    "wo"}
    jcfg = jax_reduced(jax_get_config("granite-3-2b"), family="moe",
                       moe=JMoEConfig(**dataclasses.asdict(cfg.moe)))
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    got = params_from_numpy(tree, cfg, device="cpu")
    assert "mlp" not in got["layers"]
    assert got["layers"]["moe"]["router"].dtype == torch.float32
    for name, arr in tree["layers"]["moe"].items():
        assert tuple(own["moe"][name].shape) == arr.shape
        np.testing.assert_array_equal(got["layers"]["moe"][name].numpy(),
                                      arr, err_msg=name)
