"""The port's legacy dense-cache engine (``repro_torch.core.serving``),
temperature sampling in ``generate`` and the serving CLI on the CPU,
ported from ``tests/test_serving.py`` and the legacy parts of
``tests/test_obs.py`` and ``tests/test_router.py``, and held to the JAX
package.

The contract under test: a request served through the legacy engine
yields exactly the tokens of the port's isolated greedy ``generate`` and
of the JAX ``ServingEngine`` on the same (bridged) weights, with as many
decode dispatches; its ``metrics()`` equal the JAX engine's; sampling at a
temperature gives exactly JAX's tokens under JAX's own Gumbel noise,
replayed through the ``draws`` seam; the CLI's ``--engine legacy``,
``--open-loop`` and ``--replicas 2`` serve ``generate``'s streams.
Output projections are scaled as in ``test_torch_paged_serving`` so that
streams vary.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduced as jax_reduced
from repro.core.serving import ServingEngine as JaxServingEngine
from repro.launch.serve import generate as jax_generate
from repro.models import model as JM
from repro_torch.config import get_config, reduced
from repro_torch.core.serving import ServingEngine
from repro_torch.launch import serve
from repro_torch.launch.serve import GumbelDraws, generate
from repro_torch.serving import PagedServingEngine
from repro_torch.serving.loadgen import build_workload
from repro_torch.weights import params_from_numpy

BRANCH_GAIN = 8.0        # see test_torch_paged_serving

# the metrics() contract: these exact top-level keys, on BOTH engines
METRICS_KEYS = {"scheduler", "blocks", "tick", "token_budget",
                "kv_dtype", "preempt", "swapped_requests_waiting",
                "prefix_cache", "speculative", "dispatches",
                "attention_backend", "cluster", "oom_finished",
                "telemetry", "queue_depth", "free_page_fraction"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """Reduced granite-3-2b, fp32, the JAX package's init through numpy:
    (JAX cfg, JAX params, port cfg, port params), the same weights."""
    jcfg = jax_reduced(jax_get_config("granite-3-2b"))
    cfg = reduced(get_config("granite-3-2b"))
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    for k in ("attn", "mlp"):
        tree["layers"][k]["wo"] = tree["layers"][k]["wo"] * BRANCH_GAIN
    return (jcfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_numpy(tree, cfg, device="cpu"))


def _engine(cfg, params, **kw):
    return ServingEngine(cfg, params, device="cpu", **kw)


def _ref(cfg, params, prompt, gen):
    out = generate(cfg, params, torch.from_numpy(prompt)[None], gen)
    return out[0, len(prompt):].tolist()


def _prompts(cfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
            for n in lens]


# ---------------------------------------------------------------------------
# the legacy engine
# ---------------------------------------------------------------------------

def test_matches_isolated_generation(setup):
    _, _, cfg, params = setup
    eng = _engine(cfg, params, max_slots=2, max_seq=48)
    prompts = _prompts(cfg, 0, (5, 8, 6))
    gens = [5, 3, 6]
    ids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    results = eng.run_to_completion()
    for rid, p, g in zip(ids, prompts, gens):
        assert results[rid] == _ref(cfg, params, p, g)
    assert len({t for r in results.values() for t in r}) > 3


def test_slots_recycled(setup):
    _, _, cfg, params = setup
    eng = _engine(cfg, params, max_slots=1, max_seq=32)
    ids = [eng.submit(np.arange(3, dtype=np.int32) + i, 2) for i in range(3)]
    results = eng.run_to_completion()
    assert set(results) == set(ids)          # 3 requests through 1 slot
    assert all(len(v) == 2 for v in results.values())
    assert eng.active == 0 and not eng.queue


def test_streams_dispatches_and_metrics_match_jax_engine(setup):
    """The same requests, mid-flight admission included, through the JAX
    engine and the port's: the same streams, the same number of decode
    dispatches, equal ``metrics()``."""
    jcfg, jparams, cfg, params = setup
    prompts = _prompts(cfg, 4, (7, 3, 9, 5))
    gens = [6, 8, 4, 1]
    outs, metrics, dispatches = [], [], []
    for eng in (JaxServingEngine(jcfg, jparams, max_slots=2, max_seq=24),
                _engine(cfg, params, max_slots=2, max_seq=24)):
        ids = [eng.submit(p, g) for p, g in zip(prompts[:2], gens[:2])]
        eng.step()
        ids += [eng.submit(p, g) for p, g in zip(prompts[2:], gens[2:])]
        res = eng.run_to_completion()
        outs.append([res[i] for i in ids])
        metrics.append(eng.metrics())
        dispatches.append(eng.dispatches)
    assert outs[0] == outs[1]
    assert outs[1] == [_ref(cfg, params, p, g) for p, g in zip(prompts, gens)]
    assert dispatches[0] == dispatches[1]
    assert metrics[0] == metrics[1]


def test_slot_commit_touches_only_its_slot(setup):
    """A slot's step writes that slot's cache rows at its position and
    nothing else: the port's in-place write through the slot view is the
    JAX engine's per-slot commit."""
    _, _, cfg, params = setup
    eng = _engine(cfg, params, max_slots=3, max_seq=16)
    g = torch.Generator().manual_seed(0)
    for t in eng.cache["kv"].values():
        t.copy_(torch.randn(t.shape, generator=g))
    before = {n: t.clone() for n, t in eng.cache["kv"].items()}
    eng.slot_pos[1] = 5
    eng._step_one_slot(1, 7)
    for n, t in eng.cache["kv"].items():
        changed = (t != before[n]).flatten(3).any(-1)     # (L, B, S)
        assert changed[:, 1, 5].all()
        changed[:, 1, 5] = False
        assert not changed.any(), n
    assert eng.slot_pos.tolist() == [0, 6, 0] and eng.dispatches == 1


def test_legacy_engine_metrics_schema(setup):
    """The legacy engine's metrics() pins the paged engine's top-level
    schema, so serve.py reports stay diffable across --engine."""
    _, _, cfg, params = setup
    eng = _engine(cfg, params, max_slots=2, max_seq=32)
    rng = np.random.default_rng(0)
    eng.submit(rng.integers(0, cfg.vocab, 6).astype(np.int32), 4)
    eng.run_to_completion()
    m = eng.metrics()
    assert set(m) == METRICS_KEYS
    assert m["tick"] == "slot" and m["dispatches"] > 0
    assert m["telemetry"]["enabled"] is False
    assert m["scheduler"]["num_finished"] == 1


def test_metrics_schema_snapshot(setup):
    """The router's balancing snapshot has the same schema on both
    engines, and queued requests move it."""
    _, _, cfg, params = setup
    paged = PagedServingEngine(cfg, params, max_slots=2, block_size=4,
                               max_blocks_per_seq=8, num_blocks=16,
                               device="cpu")
    legacy = _engine(cfg, params, max_slots=2, max_seq=32)
    pm, lm = paged.metrics(), legacy.metrics()
    assert set(pm) == set(lm) == METRICS_KEYS
    for m in (pm, lm):
        assert m["queue_depth"] == 0
        assert m["free_page_fraction"] == 1.0
    paged.submit(np.arange(5, dtype=np.int32), 2)
    legacy.submit(np.arange(5, dtype=np.int32), 2)
    assert paged.metrics()["queue_depth"] == 1
    assert legacy.metrics()["queue_depth"] == 1
    s = paged.scheduler.summary()
    assert s["queue_depth"] == s["waiting"] == 1
    paged.run_to_completion()
    legacy.run_to_completion()
    assert paged.metrics()["queue_depth"] == 0
    assert paged.metrics()["free_page_fraction"] <= 1.0
    assert legacy.metrics()["free_page_fraction"] == 1.0


def test_stuck_guard_legacy_core_engine(setup):
    """The dense-cache engine carries the paged engine's no-progress guard
    (its normal dynamics can't livelock, so the guard is exercised by
    stubbing step out)."""
    _, _, cfg, params = setup
    eng = _engine(cfg, params, max_slots=1, max_seq=32)
    eng.submit(np.arange(4, dtype=np.int32), 2)
    eng.step = lambda: {}
    with pytest.raises(RuntimeError, match="no step can make progress"):
        eng.run_to_completion(max_steps=10**9)


def test_submit_validates_and_device_rules(setup):
    _, _, cfg, params = setup
    eng = _engine(cfg, params, max_slots=1, max_seq=8)
    with pytest.raises(ValueError, match="at least one token"):
        eng.submit(np.zeros(0, np.int32), 2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(np.arange(3, dtype=np.int32), 0)
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(np.arange(8, dtype=np.int32), 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(cfg, params, max_slots=1, max_seq=8)
    with pytest.raises(ValueError, match="params are on"):
        ServingEngine(cfg, params, max_slots=1, max_seq=8,
                      device="meta")


# ---------------------------------------------------------------------------
# temperature sampling
# ---------------------------------------------------------------------------

def jax_gumbel(key, steps, shape):
    """The Gumbel noise JAX's ``generate`` draws at each step (``key, k =
    split(key)``; ``categorical(k, l) = argmax(gumbel(k) + l)``)."""
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.gumbel(k, shape, jnp.float32))))
    return out


@pytest.mark.parametrize("temperature,seed", [(0.7, 0), (1.3, 5)])
def test_sampling_matches_jax_under_replayed_noise(setup, temperature, seed):
    jcfg, jparams, cfg, params = setup
    prompts = np.stack(_prompts(cfg, 6, (6, 6, 6)))
    gen = 7
    want = np.asarray(jax_generate(jcfg, jparams, jnp.asarray(prompts), gen,
                                   temperature=temperature,
                                   key=jax.random.PRNGKey(seed)))
    noise = jax_gumbel(jax.random.PRNGKey(seed), gen,
                       (3, params["embed"]["table"].shape[0]))
    got = generate(cfg, params, torch.from_numpy(prompts), gen,
                   temperature=temperature,
                   draws=lambda i, shape: noise[i])
    assert got.tolist() == want.tolist()
    greedy = generate(cfg, params, torch.from_numpy(prompts), gen)
    assert got[:, 6:].tolist() != greedy[:, 6:].tolist()


def test_sampling_seeded_by_its_generator(setup):
    _, _, cfg, params = setup
    prompts = torch.from_numpy(np.stack(_prompts(cfg, 7, (5, 5))))

    def sample(seed, temperature=0.7):
        g = torch.Generator().manual_seed(seed)
        return generate(cfg, params, prompts, 8, temperature=temperature,
                        generator=g).tolist()

    assert sample(1) == sample(1)
    assert sample(1) != sample(2)
    assert sample(1, 0.0) == sample(2, 0.0) == generate(
        cfg, params, prompts, 8).tolist()


def test_gumbel_draws_are_standard_gumbel():
    d = GumbelDraws(torch.Generator().manual_seed(0), torch.device("cpu"))
    x = d(0, (200_000,)).double()
    assert x.dtype == torch.float64 and torch.isfinite(x).all()
    assert abs(x.mean().item() - 0.5772156649) < 0.01      # Euler's gamma
    assert abs(x.var().item() - np.pi ** 2 / 6) < 0.03
    assert not torch.equal(d(1, (8,)), d(2, (8,)))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

BASE = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
        "--batch", "2", "--prompt-len", "6", "--gen", "5",
        "--block-size", "4"]


@pytest.mark.parametrize("argv", [
    ["--engine", "legacy"],
    ["--open-loop", "--requests", "5", "--rate", "400"],
    ["--replicas", "2", "--prefix-cache"],
    ["--replicas", "2", "--routing", "rr", "--open-loop", "--mix", "agents",
     "--requests", "4", "--rate", "400"],
], ids=["legacy", "open_loop", "replicas", "replicas_rr_open_loop"])
def test_cli_streams_equal_generate(setup, argv, capsys):
    """``--engine legacy``, ``--open-loop`` and ``--replicas 2`` serve
    exactly ``generate``'s greedy streams (the workload rebuilt from the
    same seed)."""
    _, _, cfg, params = setup
    args = serve.parse_args(BASE + argv)
    report, streams = serve.run(cfg, params, args)
    if args.open_loop:
        wl = build_workload(mix=args.mix, arrivals=args.arrivals,
                            n=args.requests, seed=args.seed,
                            vocab=cfg.vocab, rate=args.rate)
        reqs = [(r.prompt, r.max_new_tokens) for r in wl]
        assert report["open_loop"]["finished"] == len(wl)
        assert report["workload"]["requests"] == len(wl)
    else:
        rng = np.random.default_rng(args.seed + 1)
        prompts = rng.integers(0, cfg.vocab, (2, 6), dtype=np.int32)
        reqs = [(p, 5) for p in prompts]
    assert [streams[i] for i in sorted(streams)] == [
        _ref(cfg, params, p, g) for p, g in reqs]
    assert report["output_shape"] == [len(reqs)]
    assert report["engine"] == args.engine
    if args.replicas > 1:
        assert report["fleet"]["replicas"] == 2
        assert report["fleet"]["finished"] == len(reqs)
    if args.engine == "legacy":
        assert report["tick"] == "slot"


def test_cli_main_runs_each_new_path(capsys):
    for argv in (["--engine", "legacy"], ["--open-loop", "--requests", "3",
                                          "--rate", "500"],
                 ["--replicas", "2"],
                 ["--engine", "batch", "--temperature", "0.8"]):
        report = serve.main(BASE + argv)
        assert report["tokens_per_s"] > 0
    assert '"open_loop"' in capsys.readouterr().out


def test_cli_batch_temperature_samples_from_seed(setup):
    _, _, cfg, params = setup
    argv = BASE + ["--engine", "batch", "--temperature", "0.9",
                   "--seed", "3"]
    report, out = serve.run(cfg, params, serve.parse_args(argv))
    assert set(report) == {"arch", "engine", "batch", "prompt_len",
                           "generated", "device", "wall_s", "tokens_per_s",
                           "output_shape"}
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (2, 6),
                                                dtype=np.int32)
    want = generate(cfg, params, torch.from_numpy(prompts), 5,
                    temperature=0.9,
                    generator=torch.Generator().manual_seed(3))
    assert out.tolist() == want.tolist()


@pytest.mark.parametrize("argv", [
    ["--engine", "legacy", "--replicas", "2"],
    ["--engine", "paged", "--replicas", "0"],
    ["--engine", "paged", "--replicas", "2", "--trace", "t.json"],
    ["--engine", "legacy", "--temperature", "0.5"],
    ["--engine", "legacy", "--trace", "t.jsonl"],
    ["--engine", "legacy", "--open-loop"],
    ["--engine", "batch", "--prefix-cache"],
    ["--open-loop", "--arrivals", "trace"],
], ids=["legacy_replicas", "zero_replicas", "merged_chrome_trace",
        "legacy_temperature", "legacy_trace", "legacy_open_loop",
        "batch_paged_knob", "trace_without_file"])
def test_cli_flag_validation(argv, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(BASE + argv)
    assert "error" in capsys.readouterr().err
