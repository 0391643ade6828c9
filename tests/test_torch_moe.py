"""The port's MoE family (``repro_torch.models.moe``, the MoE layer of the
stack and of the paged step) and the configs copied with it (olmoe-1b-7b,
grok-1-314b, glm4-9b, gemma3-4b) against the JAX package's, on the same
weights, reduced (2 layers, d 64, 4 experts top-2), fp32.

Tolerances: ``apply_moe`` and ``aux_loss`` 1e-5 of the largest reference
value (fp32 products summed in another order); full-sequence logits 1e-4
relative to the largest logit (two layers of such sums); greedy streams
identical; parameter counts exact.

Both output projections (``attn.wo`` and the experts' ``moe.wo``) are
scaled by ``BRANCH_GAIN`` for the engine tests, as in
``tests/test_torch_paged_serving.py``: at random init greedy decoding
otherwise repeats the last prompt token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduced as jax_reduced
from repro.launch.serve import generate as jax_generate
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models.layers import logits_from_hidden as jax_logits
from repro.serving import PagedServingEngine as JaxPagedServingEngine
from repro_torch.config import get_config, reduced
from repro_torch.core.platform import Platform
from repro_torch.core.resources import DevicePool
from repro_torch.launch import serve
from repro_torch.launch.serve import generate
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.layers import logits_from_hidden
from repro_torch.serving import PagedServingEngine
from repro_torch.train.steps import make_train_step
from repro_torch.weights import params_from_numpy, params_to_numpy

ARCHS = ["olmoe-1b-7b", "grok-1-314b", "glm4-9b", "gemma3-4b"]
MOE_ARCHS = ["olmoe-1b-7b", "grok-1-314b"]
BRANCH_GAIN = 8.0
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bridged(arch, seed=0):
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(seed)))
    return jcfg, tree, cfg


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg, tree, cfg = _bridged(arch)
        out[arch] = (jcfg, jax.tree.map(jnp.asarray, tree), tree, cfg,
                     params_from_numpy(tree, cfg, device="cpu"))
    return out


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _close(got, want, rel):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-6))


def _layer0(tree):
    return {k: v[0] for k, v in tree["layers"]["moe"].items()}


def _x(seed, B, S, d):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cap", [None, 4], ids=["dropless", "cap4"])
def test_apply_moe_matches_jax(models, arch, cap):
    """Layer 0's MoE block on the same input: output and aux loss within
    1e-5; with an explicit capacity of 4 rows an expert, assignments
    drop (counted by ``route``) and the outputs still agree."""
    jcfg, _, tree, cfg, params = models[arch]
    x = _x(3, 2, 16, cfg.d_model)
    want, want_aux = jmoe.apply_moe(jax.tree.map(jnp.asarray, _layer0(tree)),
                                    jnp.asarray(x), jcfg, cap=cap)
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    with torch.no_grad():
        got, aux = moe.apply_moe(lp, torch.from_numpy(x), cfg, cap=cap)
        C = cap if cap is not None else moe.capacity(32, cfg)
        r = moe.route(lp["router"], torch.from_numpy(x).reshape(32, -1),
                      cfg, C)
    dropped = int((~r.keep).sum())
    if cap is None:
        assert dropped == 0 and C == moe.capacity(32, cfg) == 128
    else:
        assert dropped > 0
    _close(got.numpy(), want, 1e-5)
    _close(aux.numpy(), want_aux, 1e-5)
    # the drops are real: without them the output differs
    if cap is not None:
        full, _ = moe.apply_moe(lp, torch.from_numpy(x), cfg)
        assert not np.allclose(full.numpy(), got.numpy(), atol=1e-3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_loss_matches_jax_and_routing_ranks_in_order(models, arch):
    """``aux_loss`` on drawn router logits, and ``route``'s slots against
    JAX's stable-argsort ranks, where earlier tokens win capacity."""
    jcfg, _, tree, cfg, params = models[arch]
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    logits = np.random.default_rng(5).standard_normal((40, E)).astype(
        np.float32)
    ids = np.argsort(-logits, axis=-1)[:, :k]
    want = jmoe.aux_loss(jnp.asarray(logits), jnp.asarray(ids), E)
    got = moe.aux_loss(torch.from_numpy(logits), torch.from_numpy(ids), E)
    _close(got.numpy(), want, 1e-5)
    xf = _x(6, 1, 40, cfg.d_model)[0]
    r = moe.route(params["layers"]["moe"]["router"][0], torch.from_numpy(xf),
                  cfg, 8)
    flat = r.expert_ids.reshape(-1).numpy()
    for e in range(E):
        mine = np.flatnonzero(flat == e)
        assert r.keep.numpy()[mine].tolist() == \
            [i < 8 for i in range(len(mine))]
        kept = r.dest.numpy()[mine[:8]]
        assert kept.tolist() == [e * 8 + i for i in range(len(kept))]
    assert (r.dest.numpy()[~r.keep.numpy()] == E * 8).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_forward_logits_match_jax(models, arch):
    """JAX's ``init_params`` tree through ``params_from_numpy``: the same
    leaves (the router fp32), the port's own init draws the same shapes,
    the analytic count is exact, and full-sequence logits lie within 1e-4
    of JAX's ``M.forward``."""
    jcfg, jp, tree, cfg, params = models[arch]
    back = dict(_leaves(params_to_numpy(params)))
    want = dict(_leaves(tree))
    assert back.keys() == want.keys()
    for name, arr in want.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    own = dict(_leaves(M.init_params(cfg, seed=0, device="cpu")))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in want.items()}
    assert M.count_params(cfg) == sum(v.size for v in want.values())
    if cfg.moe is not None:
        assert "mlp" not in params["layers"]
        assert params["layers"]["moe"]["router"].dtype == torch.float32
        bf = params_from_numpy(tree, dataclasses.replace(
            cfg, dtype="bfloat16"), device="cpu")["layers"]["moe"]
        assert bf["router"].dtype == torch.float32
        assert bf["wo"].dtype == torch.bfloat16
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16),
                                             dtype=np.int32)
    jh, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    want_l = np.asarray(jax_logits(jp, jh, jcfg))[..., :cfg.vocab]
    with torch.no_grad():
        h = M.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
        got = logits_from_hidden(params, h, cfg).numpy()[..., :cfg.vocab]
    np.testing.assert_allclose(got, want_l, rtol=1e-4,
                               atol=1e-4 * np.abs(want_l).max())


def test_gemma3_local_window_matches_jax(models):
    """The counterpart of ``tests/test_models.py::
    test_sliding_window_masks_differ``: reduced gemma3-4b (window 8, a
    global layer every sixth: both layers local) at 16 tokens masks the
    local layers, so its last hidden row differs from an all-global
    stack's, and both lie within 1e-4 of JAX's."""
    jcfg, jp, _, cfg, params = models["gemma3-4b"]
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16),
                                             dtype=np.int32)
    outs = []
    for change in ({}, dict(sliding_window=0, global_every=0)):
        jh, _ = JM.forward(dataclasses.replace(jcfg, **change), jp,
                           {"tokens": jnp.asarray(toks)})
        with torch.no_grad():
            h = M.forward(dataclasses.replace(cfg, **change), params,
                          {"tokens": torch.from_numpy(toks)}).numpy()
        _close(h, np.asarray(jh), 1e-4)
        outs.append(h)
    assert np.allclose(outs[0][:, :8], outs[1][:, :8], atol=1e-5)
    assert not np.allclose(outs[0][:, -1], outs[1][:, -1])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_generate_token_identical_to_jax(models, arch):
    jcfg, jp, _, cfg, params = models[arch]
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (2, 6),
                                                dtype=np.int32)
    want = np.asarray(jax_generate(jcfg, jp, jnp.asarray(prompts), 7))
    got = generate(cfg, params, torch.from_numpy(prompts), 7)
    np.testing.assert_array_equal(got.numpy(), want)


def _amplified(arch):
    jcfg, tree, cfg = _bridged(arch)
    for k in ("attn", "moe"):
        tree["layers"][k]["wo"] = tree["layers"][k]["wo"] * BRANCH_GAIN
    return jcfg, tree, cfg


def _prompts(seed, cfg, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
            for n in lens]


def _ref(cfg, params, prompt, gen):
    out = generate(cfg, params, torch.from_numpy(prompt)[None], gen)
    return out[0, len(prompt):].tolist()


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_engine_streams_match_generate_and_jax(kv_dtype):
    """The counterpart of ``tests/test_paged_serving.py::
    test_moe_arch_exact``: reduced olmoe-1b-7b (dropless) through the
    port's paged engine, ragged prompts, chunked prefill crossing pages,
    a token budget; streams equal the port's ``generate`` (fp pages) and
    the JAX engine's on the same weights and pages."""
    jcfg, tree, cfg = _amplified("olmoe-1b-7b")
    params = params_from_numpy(tree, cfg, device="cpu")
    kw = dict(max_slots=2, block_size=4, max_blocks_per_seq=8,
              prefill_chunk=3, token_budget=5, kv_dtype=kv_dtype)
    prompts = _prompts(6, cfg, (5, 7, 9))
    gens = [5, 6, 4]
    jeng = JaxPagedServingEngine(jcfg, jax.tree.map(jnp.asarray, tree), **kw)
    teng = PagedServingEngine(cfg, params, device="cpu", **kw)
    outs = []
    for eng in (jeng, teng):
        ids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
        res = eng.run_to_completion()
        outs.append([res[i] for i in ids])
    assert outs[0] == outs[1]
    assert len({t for s in outs[1] for t in s}) > 3
    assert teng.metrics()["kv_dtype"] == kv_dtype
    if kv_dtype == "fp":
        for got, p, g in zip(outs[1], prompts, gens):
            assert got == _ref(cfg, params, p, g)


def test_engine_prefix_cache_exact():
    """The prefix cache over the MoE stack: a re-served prompt hits its
    pages and the streams equal ``generate``."""
    _, tree, cfg = _amplified("olmoe-1b-7b")
    params = params_from_numpy(tree, cfg, device="cpu")
    eng = PagedServingEngine(cfg, params, device="cpu", max_slots=1,
                             block_size=4, max_blocks_per_seq=8,
                             prefill_chunk=4, prefix_cache=True)
    prompt = _prompts(8, cfg, (10,))[0]
    ids = [eng.submit(prompt, 5) for _ in range(2)]
    res = eng.run_to_completion()
    ref = _ref(cfg, params, prompt, 5)
    assert [res[i] for i in ids] == [ref, ref]
    assert eng.metrics()["prefix_cache"]["hit_tokens"] > 0


@pytest.mark.parametrize("engine", ["paged", "legacy", "batch"])
def test_cli_serves_olmoe(engine, capsys):
    """``launch/serve.py --arch olmoe-1b-7b --reduced --device cpu`` on
    each engine: the report, and (through ``run``) streams equal to
    ``generate`` on the CLI's own weights and prompts."""
    argv = ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
            "--engine", engine, "--batch", "2", "--prompt-len", "6",
            "--gen", "4", "--block-size", "4"]
    report = serve.main(argv)
    assert report["arch"] == "olmoe-1b-7b-smoke"
    assert report["engine"] == engine and report["device"] == "cpu"
    args = serve.parse_args(argv)
    cfg = reduced(get_config("olmoe-1b-7b"))
    params = M.init_params(cfg, seed=args.seed, device="cpu")
    _, out = serve.run(cfg, params, args)
    prompts = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (2, 6), dtype=np.int32)
    want = generate(cfg, params, torch.from_numpy(prompts), 4)
    if engine == "batch":
        np.testing.assert_array_equal(out.numpy(), want.numpy())
    else:
        assert [out[i] for i in sorted(out)] == want[:, 6:].tolist()
    capsys.readouterr()


@pytest.mark.parametrize("arch", ["glm4-9b", "gemma3-4b", "grok-1-314b"])
def test_cli_serves_the_other_configs(arch, capsys):
    """The CLI's paged engine on each new config, reduced: streams equal
    ``generate`` (gemma3-4b's 20-token prompts cross its window of 8)."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "20", "--gen", "4", "--block-size", "4"]
    args = serve.parse_args(argv)
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, seed=0, device="cpu")
    report, out = serve.run(cfg, params, args)
    assert report["arch"] == arch + "-smoke"
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 20),
                                                dtype=np.int32)
    want = generate(cfg, params, torch.from_numpy(prompts), 4)
    assert [out[i] for i in sorted(out)] == want[:, 20:].tolist()
    capsys.readouterr()


def test_serve_on_cluster_serves_moe(tmp_path):
    """The platform's serve verb on reduced olmoe-1b-7b: streams equal
    ``generate``."""
    platform = Platform(tmp_path, pool=DevicePool([CPU]))
    cfg = reduced(get_config("olmoe-1b-7b"))
    params = M.init_params(cfg, seed=0, device=CPU)
    reqs = [(p, 4) for p in _prompts(3, cfg, (5, 3))]
    platform.create_instance("srv")
    h = platform.serve_on_cluster("srv", cfg, params, reqs, runname="s",
                                  max_slots=2, block_size=4,
                                  max_blocks_per_seq=4)
    out = h.result["results"]
    for rid, (p, g) in zip(sorted(out), reqs):
        assert out[rid] == _ref(cfg, params, p, g)


def test_moe_training_raises():
    """MoE training waits for its aux term: ``loss_fn`` and the train step
    raise with the ROADMAP item, rather than train without it."""
    cfg = reduced(get_config("olmoe-1b-7b"))
    params = M.init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        M.loss_fn(cfg, params, {"tokens": toks, "labels": toks})
    with pytest.raises(NotImplementedError, match="aux term"):
        make_train_step(cfg)
    dense = reduced(get_config("glm4-9b"))
    make_train_step(dense)
