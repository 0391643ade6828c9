"""The port's checkpoint manager, preemptible trainer and training
launcher (``repro_torch.{checkpoint,ft,launch.train}``): the ports of
``tests/test_checkpoint_ft.py``'s checkpoint and preemption tests, a bf16
leaf and a ``TrainState`` round trip, and a CPU run of the launcher
through the five verbs.  A preempted run must equal an uninterrupted one
bit for bit (CPU, deterministic kernels)."""
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointError, CheckpointManager
from repro_torch.config import get_config, reduced
from repro_torch.core import tree
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.ft.preemption import PreemptibleTrainer, PreemptionSchedule
from repro_torch.launch import train as train_driver
from repro_torch.train.steps import (TrainState, init_train_state,
                                     make_train_step)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_cfg():
    return reduced(get_config("granite-3-2b"), n_layers=1, d_model=32,
                   d_ff=64, vocab=64, n_heads=2, n_kv_heads=1, head_dim=16)


def test_roundtrip_identity(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = {"a": np.arange(10.0), "b": {"c": np.ones((3, 4), np.float32)}}
    mgr.save(5, t)
    out = mgr.restore(5)
    np.testing.assert_array_equal(out["a"], t["a"])
    np.testing.assert_array_equal(out["b"]["c"], t["b"]["c"])
    assert out["b"]["c"].dtype == np.float32


def test_corruption_detected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": np.arange(10.0)})
    leaf = mgr.step_dir(1) / "leaf_0.npy"
    arr = np.load(leaf)
    arr[0] = 999.0
    np.save(leaf, arr)
    with pytest.raises(CheckpointError):
        mgr.restore(1)


def test_interrupted_save_never_corrupts_latest(tmp_path):
    """A stale .tmp dir (simulated crash mid-save) must not shadow the
    committed checkpoint."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": np.arange(3.0)})
    junk = tmp_path / ".tmp-2"
    junk.mkdir()
    (junk / "leaf_0.npy").write_bytes(b"garbage")
    assert mgr.latest_step() == 1
    out = mgr.restore()
    np.testing.assert_array_equal(out["a"], np.arange(3.0))


def test_async_save(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": np.arange(100.0)}, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_keep_last_collects_old_steps(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2)
    for s in (1, 2, 3):
        mgr.save(s, {"a": np.full(2, float(s))})
    assert mgr.steps() == [2, 3]
    with pytest.raises(CheckpointError):
        CheckpointManager(tmp_path / "empty").restore()


def test_bf16_and_tensor_leaves_round_trip(tmp_path):
    """numpy has no bfloat16: the leaf is stored as its bit pattern and
    comes back a bf16 tensor, bit-equal; every tensor keeps its dtype."""
    rng = np.random.default_rng(0)
    t = {"w": torch.from_numpy(rng.standard_normal((5, 7)).astype(
        np.float32)).to(torch.bfloat16),
         "f": torch.from_numpy(rng.standard_normal(3).astype(np.float32)),
         "q": torch.tensor([[-127, 3, 127]], dtype=torch.int8),
         "n": torch.tensor(4, dtype=torch.int32)}
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, t)
    meta = json.loads((mgr.step_dir(3) / "manifest.json").read_text())
    assert {m["dtype"] for m in meta["leaves"]} == {"bfloat16", "float32",
                                                    "int8", "int32"}
    out = mgr.restore(3)
    for k, v in t.items():
        assert out[k].dtype == v.dtype and torch.equal(out[k], v), k


def test_train_state_round_trip(tmp_path):
    cfg = _tiny_cfg()
    st = init_train_state(cfg, seed=0, device="cpu")
    mgr = CheckpointManager(tmp_path)
    mgr.save(0, st)
    out = mgr.restore(0)
    assert isinstance(out, TrainState)
    for a, b in zip(tree.flatten(st)[0], tree.flatten(out)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_preempted_equals_uninterrupted(tmp_path):
    cfg = _tiny_cfg()
    step_fn = make_train_step(cfg)
    data = SyntheticLM(cfg.vocab, seed=0)
    batch_fn = lambda s: data.batch(s, 2, 9)  # noqa: E731
    st0 = init_train_state(cfg, seed=0, device="cpu")

    t1 = PreemptibleTrainer(step_fn, batch_fn,
                            CheckpointManager(tmp_path / "a"),
                            checkpoint_every=4, async_checkpoint=False)
    r1 = t1.run_with_restarts(st0, 12,
                              schedule=PreemptionSchedule([6, 9]))
    t2 = PreemptibleTrainer(step_fn, batch_fn,
                            CheckpointManager(tmp_path / "b"),
                            checkpoint_every=4, async_checkpoint=False)
    r2 = t2.run_with_restarts(st0, 12)
    assert len(r1["attempts"]) == 3 and r1["attempts"][1]["resumed_from"] == 4
    assert r2["attempts"] == [{"completed": True, "resumed_from": None,
                               "last_step": 12}]
    for a, b in zip(tree.flatten(r1["state"])[0],
                    tree.flatten(r2["state"])[0]):
        assert torch.equal(a, b)


def test_train_launcher_through_the_verbs_on_cpu(tmp_path):
    """launch.train on the CPU with the flash path and one preemption:
    the loss falls, the attempts show the resume, the results land in the
    run's directory, and the final params equal an uninterrupted run's."""
    argv = ["--reduced", "--device", "cpu", "--pallas-attention",
            "--d-model", "32", "--n-layers", "2", "--vocab", "64",
            "--batch", "4", "--seq", "16", "--steps", "8", "--lr", "3e-3",
            "--checkpoint-every", "2"]
    rep = train_driver.main(argv + ["--preempt-at", "5", "--workspace",
                                    str(tmp_path / "a")])
    ref = train_driver.main(argv + ["--workspace", str(tmp_path / "b")])
    assert rep["device"] == "cpu" and rep["steps"] == 8
    assert [a["resumed_from"] for a in rep["attempts"]] == [None, 4]
    assert rep["last_loss"] < rep["first_loss"]
    out = tmp_path / "a" / "results" / "train"
    assert (out / "report.json").exists() and (out / "losses.npz").exists()
    for a, b in zip(tree.flatten(rep["state"])[0],
                    tree.flatten(ref["state"])[0]):
        assert torch.equal(a, b)
    if not torch.cuda.is_available():      # without --device cpu: the GPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_driver.main(argv[:1] + argv[3:] + [
                "--workspace", str(tmp_path / "c")])
