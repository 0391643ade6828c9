"""The port's two-dispatch tick (``PagedServingEngine(unified=False)``) on the
CPU: a prefill pass, then a decode pass, per tick.

The contract under test: it emits, tick for tick, what the unified tick
emits (the port of ``test_unified_one_dispatch_per_tick_matches_legacy_
streams``), exactly the tokens of the port's isolated greedy
``generate``, under preemption and with int8 pages the unified tick's
tokens; and the same streams and dispatch count as the JAX engine's
two-dispatch tick on bridged weights.  The CLI's ``--tick``,
``--prefix-cache`` and ``--kv-dtype`` reach the engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduced as jax_reduced
from repro.models import model as JM
from repro.serving import PagedServingEngine as JaxPagedServingEngine
from repro_torch.config import get_config, reduced
from repro_torch.launch.serve import generate
from repro_torch.models import model as M
from repro_torch.serving import PagedServingEngine
from repro_torch.weights import params_from_numpy

BRANCH_GAIN = 8.0        # see test_torch_paged_serving


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("granite-3-2b"))
    params = M.init_params(cfg, seed=0, device="cpu")
    for k in ("attn", "mlp"):
        params["layers"][k]["wo"] = params["layers"][k]["wo"] * BRANCH_GAIN
    return cfg, params


def _ref(cfg, params, prompt, gen):
    out = generate(cfg, params, torch.from_numpy(prompt)[None], gen)
    return out[0, len(prompt):].tolist()


def _prompts(seed, cfg, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
            for n in lens]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_unified_one_dispatch_per_tick_matches_legacy_streams(setup,
                                                             kv_dtype):
    """The unified tick issues at most ONE pass per step and emits, tick
    for tick, the same {req_id: token} dicts as the two-dispatch tick on a
    trace where prefill and decode overlap throughout; the two-dispatch
    tick pays a second pass whenever they do.  With fp pages the streams
    equal generate's; with int8 pages the two ticks agree with each
    other."""
    cfg, params = setup
    kw = dict(max_slots=2, block_size=4, max_blocks_per_seq=12,
              prefill_chunk=3, kv_dtype=kv_dtype, device="cpu")
    eng_u = PagedServingEngine(cfg, params, **kw)
    eng_l = PagedServingEngine(cfg, params, unified=False, **kw)
    prompts = _prompts(8, cfg, (9, 5, 11, 2))
    gens = [6, 8, 3, 5]
    for eng in (eng_u, eng_l):
        for p, g in zip(prompts, gens):
            eng.submit(p, g)
    ticks = working = 0
    while eng_u.scheduler.has_waiting or eng_u.active:
        before = eng_u.dispatches
        out_u = eng_u.step()
        out_l = eng_l.step()
        assert out_u == out_l                    # same emissions, same tick
        assert eng_u.dispatches - before <= 1    # ONE pass per tick
        working += eng_u.dispatches - before
        ticks += 1
    assert eng_u.metrics()["tick"] == "unified"
    assert eng_l.metrics()["tick"] == "legacy"
    assert eng_u.dispatches == working <= ticks
    assert eng_l.dispatches > eng_u.dispatches
    res_u, res_l = eng_u.run_to_completion(), eng_l.run_to_completion()
    assert res_u == res_l
    if kv_dtype is None:
        for rid, p, g in zip(sorted(res_l), prompts, gens):
            assert res_l[rid] == _ref(cfg, params, p, g)


@pytest.mark.parametrize("policy", ["longest", "newest"])
def test_legacy_preemption_recompute_exact(setup, policy):
    """A pool too small for both requests forces preemption mid-decode on
    the two-dispatch tick; recomputation reproduces generate's streams."""
    cfg, params = setup
    prompts = _prompts(3, cfg, (6, 7))
    gens = [9, 8]
    eng = PagedServingEngine(cfg, params, max_slots=2, block_size=4,
                             max_blocks_per_seq=6, num_blocks=8,
                             prefill_chunk=4, preemption_policy=policy,
                             unified=False, device="cpu")
    ids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    results = eng.run_to_completion()
    assert eng.metrics()["scheduler"]["preemptions"] >= 1
    for rid, p, g in zip(ids, prompts, gens):
        assert results[rid] == _ref(cfg, params, p, g)
    assert eng.alloc.utilization()["in_use"] == 0


def test_legacy_streams_and_dispatches_match_jax():
    """The port's two-dispatch tick against the JAX engine's on bridged
    weights: the same streams, the same number of passes, the same
    telemetry tick kinds and packed-token totals."""
    jcfg = jax_reduced(jax_get_config("granite-3-2b"))
    cfg = reduced(get_config("granite-3-2b"))
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    for k in ("attn", "mlp"):
        tree["layers"][k]["wo"] = tree["layers"][k]["wo"] * BRANCH_GAIN
    kw = dict(max_slots=2, block_size=4, max_blocks_per_seq=8,
              prefill_chunk=3, unified=False)
    prompts = _prompts(11, cfg, (7, 4, 9))
    gens = [6, 8, 5]
    jeng = JaxPagedServingEngine(jcfg, jax.tree.map(jnp.asarray, tree), **kw)
    teng = PagedServingEngine(cfg, params_from_numpy(tree, cfg,
                                                     device="cpu"),
                              device="cpu", **kw)
    outs = []
    for eng in (jeng, teng):
        ids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
        res = eng.run_to_completion()
        outs.append([res[i] for i in ids])
    assert outs[0] == outs[1]
    assert teng.dispatches == jeng.dispatches
    jt, tt = (e.telemetry.summary() for e in (jeng, teng))
    for key in ("ticks", "packed_tokens", "padded_tokens", "prefill_tokens",
                "decode_tokens"):
        assert tt[key] == jt[key], key


@pytest.mark.parametrize("argv,want", [
    (["--tick", "legacy"], dict(tick="legacy", kv_dtype="fp")),
    (["--prefix-cache"], dict(tick="unified", kv_dtype="fp")),
    (["--kv-dtype", "int8", "--tick", "legacy"],
     dict(tick="legacy", kv_dtype="int8"))])
def test_cli_flags_reach_the_engine(argv, want, capsys):
    """``repro_torch.launch.serve`` takes the JAX CLI's --tick,
    --prefix-cache and --kv-dtype and reports them."""
    from repro_torch.launch.serve import main
    report = main(["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "8", "--gen", "3",
                   "--block-size", "4", *argv])
    assert report["tick"] == want["tick"]
    assert report["kv_dtype"] == want["kv_dtype"]
    assert report["prefix_cache"]["enabled"] == ("--prefix-cache" in argv)
    assert report["output_shape"] == [2]
    assert '"tick"' in capsys.readouterr().out
