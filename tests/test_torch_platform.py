"""The port's platform: ports of tests/test_platform.py on a pool of CPU
devices (``[torch.device("cpu")] * n``, as the JAX tests pass ``[dev] *
n``), plus a CATopt job and a serving job through the five verbs, against
the JAX package where the two compute the same thing."""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import catopt as jc
from repro_torch.core import catopt as tc
from repro_torch.core import tree
from repro_torch.core.platform import Platform
from repro_torch.core.resources import (DevicePool, ResourceError,
                                        VolumeStore, check_model_axis)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def platform(tmp_path):
    return Platform(tmp_path, pool=DevicePool([CPU] * 4))


def test_five_verb_lifecycle(platform):
    vol = platform.create_volume()
    vol.put("bulk", {"il": np.ones((8, 4))})
    c = platform.create_cluster("c1", 1, volume=vol.volume_id)
    assert c.master == CPU and c.workers == []
    stats = platform.send_data_to_cluster("c1", project={"x": np.arange(4.0)})
    assert stats.entries_sent == 1

    def job(ctx):
        assert ctx.volume.get("bulk")["il"].shape == (8, 4)
        y = float(np.sum(ctx.project["x"]))
        ctx.save_result("y", y)
        return y

    h = platform.run_on_cluster("c1", job, runname="r1")
    assert h.status == "done" and h.result == 6.0
    assert platform.get_results("r1").exists()
    platform.terminate_cluster("c1")
    assert platform.list_clusters(names_only=True) == []


def test_lock_semantics(platform):
    platform.create_cluster("c1", 1)
    platform.resource_lock("c1", in_use=True)
    with pytest.raises(ResourceError):
        platform.terminate_cluster("c1")
    with pytest.raises(ResourceError):
        platform.run_on_cluster("c1", lambda ctx: 1)
    platform.resource_lock("c1", in_use=False)
    platform.terminate_cluster("c1")


def test_volume_exclusive_attach(platform):
    vol = platform.create_volume()
    platform.create_cluster("c1", 1, volume=vol.volume_id)
    with pytest.raises(ResourceError):
        platform.create_cluster("c2", 1, volume=vol.volume_id)
    # the refused cluster holds no device
    assert len(platform.pool.free) == 3


def test_volume_or_snapshot_not_both(platform):
    vol = platform.create_volume()
    with pytest.raises(ResourceError):
        platform.create_cluster("c1", 1, volume=vol.volume_id,
                                snapshot="snap-x")


def test_snapshot_clones_data(platform):
    vol = platform.create_volume()
    vol.put("data", {"a": np.arange(3)})
    sid = vol.snapshot(platform.workspace)
    vol2 = platform.create_volume_from_snapshot(sid)
    np.testing.assert_array_equal(vol2.get("data")["a"], np.arange(3))
    vol2.put("data", {"a": np.zeros(3)})   # snapshot isolation
    np.testing.assert_array_equal(vol.get("data")["a"], np.arange(3))


def test_delta_sync_skips_unchanged(platform):
    platform.create_cluster("c1", 1)
    proj = {"a": np.arange(10.0), "b": np.ones(5)}
    s1 = platform.send_data_to_cluster("c1", project=proj)
    assert s1.entries_sent == 2
    s2 = platform.send_data_to_cluster("c1", project=proj)
    assert s2.entries_sent == 0 and s2.entries_skipped == 2
    proj["a"] = proj["a"] + 1
    s3 = platform.send_data_to_cluster("c1", project=proj)
    assert s3.entries_sent == 1 and s3.entries_skipped == 1


def test_delta_sync_of_tensors(platform):
    """Tensors are hashed like the arrays they hold."""
    platform.create_cluster("c1", 1)
    proj = {"a": torch.arange(10.0), "b": np.ones(5)}
    assert platform.send_data_to_cluster("c1", project=proj).entries_sent == 2
    s2 = platform.send_data_to_cluster("c1", project=proj)
    assert s2.entries_sent == 0 and s2.bytes_total == 80
    proj["a"] = proj["a"] + 1
    assert platform.send_data_to_cluster("c1", project=proj).entries_sent == 1


def test_dir_sync_delta(platform, tmp_path):
    src = tmp_path / "proj"
    src.mkdir()
    (src / "script.py").write_text("print('hi')")
    (src / "data.bin").write_bytes(b"x" * 1000)
    platform.create_cluster("c1", 1)
    s1 = platform.send_data_to_cluster("c1", project_dir=src)
    assert s1.entries_sent == 2
    s2 = platform.send_data_to_cluster("c1", project_dir=src)
    assert s2.entries_sent == 0
    (src / "script.py").write_text("print('changed')")
    s3 = platform.send_data_to_cluster("c1", project_dir=src)
    assert s3.entries_sent == 1


def test_interactive_mode_holds_lock(platform):
    platform.create_cluster("c1", 1)
    release = threading.Event()

    def slow_job(ctx):
        release.wait(5)
        return 42

    h = platform.run_on_cluster("c1", slow_job, mode="interactive",
                                runname="bg")
    assert platform.clusters["c1"].in_use
    with pytest.raises(ResourceError):
        platform.run_on_cluster("c1", lambda ctx: 0)
    release.set()
    h.wait(10)
    assert not h.thread.is_alive()
    assert h.result == 42 and not platform.clusters["c1"].in_use


def test_duplicate_names_rejected(platform):
    platform.create_cluster("c1", 1)
    with pytest.raises(ResourceError):
        platform.create_cluster("c1", 1)


def test_registry_survives_restart(platform, tmp_path):
    platform.create_cluster("c1", 1, description="persist me")
    p2 = Platform(tmp_path, pool=DevicePool([CPU]))   # same workspace
    rec = p2.registry.get("clusters", "c1")
    assert rec["description"] == "persist me"
    assert rec["devices"] == ["cpu"]


# --- the port's own pieces ---------------------------------------------------

def test_pool_tracks_slots_not_devices():
    pool = DevicePool([CPU] * 3)
    assert pool.allocate("a", 2) == [CPU, CPU]
    with pytest.raises(ResourceError):
        pool.allocate("b", 2)
    pool.release("a")
    assert len(pool.free) == 3


def test_pool_defaults_to_every_gpu():
    """No devices given: every CUDA device, and an error without one."""
    if torch.cuda.is_available():
        assert DevicePool().total == torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePool()


def test_model_axis_must_divide(platform):
    assert check_model_axis(4, 2) == 2
    with pytest.raises(ResourceError):
        platform.create_cluster("c1", 3, model_axis=2)
    c = platform.create_cluster("c2", 4, model_axis=4)
    assert c.tp_size == 4 and c.size == 4


def test_volume_tree_round_trip(tmp_path):
    """dicts, lists, tuples and None around numpy, tensor and scalar
    leaves; the tree definition is JSON."""
    vol = VolumeStore.create(tmp_path)
    value = {"b": [np.arange(3), (torch.ones(2), None)], "a": 2.5,
             "c": {"d": torch.zeros((2, 2), dtype=torch.int32)}}
    vol.put("v", value)
    got = vol.get("v")
    assert list(got) == ["a", "b", "c"]
    assert float(got["a"]) == 2.5
    np.testing.assert_array_equal(got["b"][0], np.arange(3))
    assert isinstance(got["b"][1], tuple) and got["b"][1][1] is None
    np.testing.assert_array_equal(got["b"][1][0], np.ones(2, np.float32))
    assert got["c"]["d"].dtype == np.int32
    leaves, treedef = tree.flatten(value)
    assert len(leaves) == 4
    assert tree.unflatten(treedef, leaves)["b"][1][1] is None


def test_save_result_is_readable(platform):
    platform.create_instance("i1")
    h = platform.run_on_instance(
        "i1", lambda ctx: ctx.save_result("r", {"w": torch.arange(4.0),
                                                "n": [1, 2]}),
        runname="sr")
    assert h.status == "done"
    out = platform.get_results("sr")
    data = np.load(out / "r.npz")
    assert sorted(data.files) == ["0", "1", "2"]
    np.testing.assert_array_equal(data["2"], np.arange(4.0))
    assert (out / "r.treedef.json").exists()


def test_catopt_job_through_the_five_verbs(platform):
    """CATopt as the paper runs it on an instance: the problem on a
    volume, the GA settings synced, the job reading both, results saved
    and fetched.  The problem is the JAX package's (through numpy) and the
    GA is the port's; it must improve on its start, never rise, and its
    best w must score its reported fitness under the JAX reference."""
    jp = jc.make_problem(jax.random.PRNGKey(0), n_events=256, n_dims=48)
    vol = platform.create_volume()
    vol.put("catopt_problem", {
        "il": np.asarray(jp.industry_losses),
        "target": np.asarray(jp.target_recovery),
        "scalars": np.array([jp.attachment, jp.limit, jp.weight_budget])})
    platform.create_instance("catopt", volume=vol.volume_id)
    platform.send_data_to_cluster("catopt", project={
        "ga": np.array([24, 6, 4, 2, 2])})

    def job(ctx):
        d = ctx.volume.get("catopt_problem")
        att, limit, budget = d["scalars"].tolist()
        prob = tc.problem_from_numpy(d["il"], d["target"], att, limit,
                                     budget, device=ctx.cluster.master)
        pop, gens, elite, pk, ps = ctx.project["ga"].tolist()
        cfg = tc.GAConfig(pop_size=pop, generations=gens, elite=elite,
                          polish_k=pk, polish_steps=ps)
        res = tc.optimize_island(prob, cfg, seed=1,
                                 device=ctx.cluster.master)
        ctx.save_result("catopt", {"w": res["w"], "history": res["history"]})
        return {"fitness": float(res["fitness"]),
                "history": res["history"].tolist()}

    h = platform.run_on_instance("catopt", job, runname="catopt-run")
    hist = np.array(h.result["history"])
    assert hist.shape == (6,) and hist[-1] < hist[0]
    assert (np.diff(hist) <= 0).all()
    saved = np.load(platform.get_results("catopt-run") / "catopt.npz")
    w = saved["1"]                                  # leaves sorted: history, w
    np.testing.assert_allclose(saved["0"], hist)
    want = float(jc.basis_risk(jp, w))
    assert abs(want - h.result["fitness"]) <= 1e-5 * want
    platform.terminate_cluster("catopt", delete_volume=True)
    assert platform.list_all_resources()["volumes"] == []


def test_serve_on_cluster_matches_generate(platform):
    """The port's paged engine behind the platform serves exactly the
    tokens of the port's isolated greedy generate (reduced granite-3-2b,
    fp32, on the CPU)."""
    from repro_torch.config import get_config, reduced
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    cfg = reduced(get_config("granite-3-2b"))
    params = M.init_params(cfg, seed=0, device=CPU)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, cfg.vocab, n).astype(np.int32), 4)
            for n in (5, 3)]
    platform.create_instance("srv")
    h = platform.serve_on_cluster("srv", cfg, params, reqs, runname="s",
                                  max_slots=2, block_size=4,
                                  max_blocks_per_seq=4)
    out = h.result["results"]
    for rid, (p, g) in zip(sorted(out), reqs):
        ref = generate(cfg, params, torch.from_numpy(p)[None], g)
        assert out[rid] == ref[0, len(p):].tolist()
    assert (platform.get_results("s") / "tokens.npz").exists()


@pytest.mark.parametrize("kw,item", [
    (dict(open_loop={"n": 2}), "Queue 1 item 9"),
    (dict(replicas=2), "Queue 1 item 9"),
    (dict(prefix_cache=True), "Queue 1 item 6"),
    (dict(speculate=True), "Queue 1 item 6"),
    (dict(kv_dtype="int8"), "Queue 2 item 1"),
    (dict(preempt="swap"), "Queue 1 item 6"),
    (dict(host_cache_pages=8), "Queue 1 item 6"),
])
def test_serve_options_not_ported(platform, kw, item):
    """Serving options of later slices, by the ROADMAP item that named them
    when they still raised.  The name is kept, though every case is ported
    now: ``open_loop`` (kw0), ``replicas=2`` (kw1), ``prefix_cache=True``
    (kw2), ``speculate=True`` (kw3), ``kv_dtype="int8"`` (kw4),
    ``preempt="swap"`` (kw5) and ``host_cache_pages=8`` (kw6) serve through
    the verbs, a repeated prompt included (kw0: a seeded open-loop
    workload on the wall clock), with exactly the tokens of the port's
    ``generate`` (reduced granite-3-2b, fp32, on the CPU), and leave the
    cluster unlocked."""
    platform.create_instance("srv")
    from repro_torch.config import get_config, reduced
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    cfg = reduced(get_config("granite-3-2b"))
    params = M.init_params(cfg, seed=0, device=CPU)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab, 8).astype(np.int32)
    reqs = [(prompt, 4), (rng.integers(0, cfg.vocab, 5).astype(np.int32), 3),
            (prompt.copy(), 4)]
    engine_kw = dict(max_slots=1, block_size=4, max_blocks_per_seq=4)
    if "open_loop" in kw:
        from repro_torch.serving.loadgen import build_workload
        reqs = [(r.prompt, r.max_new_tokens)
                for r in build_workload(vocab=cfg.vocab, **kw["open_loop"])]
        engine_kw["max_blocks_per_seq"] = 12     # the chat mix's longest
        h = platform.serve_on_cluster("srv", cfg, params, runname="s",
                                      **engine_kw, **kw)
    else:
        h = platform.serve_on_cluster("srv", cfg, params, reqs, runname="s",
                                      **engine_kw, **kw)
    out = h.result["results"]
    assert len(out) == len(reqs)
    for rid, (p, g) in zip(sorted(out), reqs):
        ref = generate(cfg, params, torch.from_numpy(p)[None], g)
        assert out[rid] == ref[0, len(p):].tolist()
    m = h.result["metrics"]
    if "open_loop" in kw:
        assert m["open_loop"]["finished"] == len(reqs) == 2
        assert m["open_loop"]["p50_ttft_s"] is not None
    if "replicas" in kw:
        assert m["fleet"]["replicas"] == 2
        assert m["fleet"]["finished"] == len(reqs)
        assert len(m["replicas"]) == 2
    if "prefix_cache" in kw:
        assert m["prefix_cache"]["enabled"]
        assert m["prefix_cache"]["hit_tokens"] > 0
    if "kv_dtype" in kw:
        assert m["kv_dtype"] == "int8"
    if "speculate" in kw:
        assert m["speculative"]["enabled"]
    if "preempt" in kw:
        assert m["preempt"] == "swap"
    if "host_cache_pages" in kw:
        assert m["blocks"]["host_cache_capacity_pages"] == 8
    assert not platform.clusters["srv"].in_use


def test_serve_takes_requests_or_open_loop(platform):
    platform.create_instance("srv")
    for requests, open_loop in (([], {"n": 2}), (None, None)):
        with pytest.raises(ValueError, match="exactly one"):
            platform.serve_on_cluster("srv", None, None, requests,
                                      open_loop=open_loop)
    assert not platform.clusters["srv"].in_use


def test_serve_needs_one_device(platform):
    platform.create_cluster("dp", 2)
    with pytest.raises(ResourceError, match="model_axis"):
        platform.serve_on_cluster("dp", None, None, [])
    platform.create_cluster("tp", 2, model_axis=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        platform.serve_on_cluster("tp", None, None, [])
