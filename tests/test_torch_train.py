"""The port's training path (``repro_torch.{models,optim,data,train}``)
against the JAX package's, on reduced granite-3-2b (2 layers, d 64, fp32)
with the same weights (through the weight bridge) and the same numpy
batches.

Tolerances: loss 1e-5 relative and gradients 1e-5 of each leaf's largest
(fp32; the two frameworks sum in other orders); AdamW with fp32, bf16 and
int8 states within 1e-6 and int8 payloads bit-equal; three train steps:
losses 1e-5 relative and params within 1e-5, except entries a near-zero
gradient of the other sign moved the other way (AdamW's early steps move
every weight by about lr whatever its gradient's size): at most 0.1 % of
the entries, each within the 2 lr per step such a flip can make.
"""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduced as jax_reduced
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.optim import schedule as JS
from repro.train.steps import init_train_state as jax_init_train_state
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.config import ShapeConfig, get_config, reduced
from repro_torch.core import tree
from repro_torch.core.tree import get_path, leaf_paths
from repro_torch.data.pipeline import SyntheticLM, make_batch_fn
from repro_torch.models import model as M
from repro_torch.optim import adamw as A
from repro_torch.optim import schedule as S
from repro_torch.train.steps import (TrainState, init_train_state,
                                     loss_and_grads, make_train_step)
from repro_torch.weights import params_from_numpy

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("granite-3-2b")),
                               **kw)
    cfg = dataclasses.replace(reduced(get_config("granite-3-2b")), **kw)
    return jcfg, cfg


@pytest.fixture(scope="module")
def weights():
    """JAX's reduced granite init as numpy (the same for every variant:
    the flash and remat fields do not change the tree)."""
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))


def _batch(seed, B=2, S=24, vocab=257):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("flash,remat", [(False, "none"), (True, "none"),
                                         (True, "full"), (False, "full"),
                                         (True, "dots")])
def test_loss_and_grads_match_jax(weights, flash, remat):
    """M.loss_fn and its gradients on the unrolled stack, with the flash
    path on (JAX: its Pallas kernels in interpret mode) and off, under
    each remat policy."""
    jcfg, cfg = _cfgs(scan_layers=False, use_pallas_attention=flash,
                      remat=remat)
    batch = _batch(1)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b), has_aux=True))(
        jax.tree.map(jnp.asarray, weights),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(weights, cfg, device="cpu",
                               param_dtype=torch.float32)
    loss, metrics, grads = loss_and_grads(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert metrics["tokens"].item() == batch["labels"].size
    for path in leaf_paths(grads):
        want = np.asarray(get_path(jg, path))
        got = get_path(grads, path)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg="/".join(path))
    # the inputs gained no gradient and were not modified
    assert all(get_path(params, p).grad is None for p in leaf_paths(params))


def test_flash_path_used_only_on_the_unrolled_stack(weights):
    """use_pallas_attention with scan_layers=True keeps the chunked
    attention, as in the JAX package: bit-equal to the flag off."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    out = {}
    for flash in (False, True):
        _, cfg = _cfgs(use_pallas_attention=flash)
        params = params_from_numpy(weights, cfg, device="cpu")
        with torch.no_grad():
            out[flash] = M.loss_fn(cfg, params, batch)[0]
    assert torch.equal(out[False], out[True])


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_matches_jax(state_dtype):
    """Three updates of a matrix (129 columns: no whole number of int8
    blocks) and a vector, from the same gradients."""
    rng = np.random.default_rng(3)
    p = {"w": rng.standard_normal((4, 129)).astype(np.float32),
         "b": rng.standard_normal((7,)).astype(np.float32)}
    jc = JA.AdamWConfig(state_dtype=state_dtype)
    tc = A.AdamWConfig(state_dtype=state_dtype)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js, ts = JA.adamw_init(jp, jc), A.adamw_init(tp, tc)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p.items()}
        jp, js = JA.adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp, 1e-2, jc)
        tp, ts = A.adamw_update({k: torch.from_numpy(v)
                                 for k, v in g.items()}, ts, tp, 1e-2, tc)
    assert int(ts["count"]) == int(js["count"]) == 3
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)
        for s in ("m", "v"):
            if state_dtype == "int8":
                np.testing.assert_array_equal(ts[s][k]["q"].numpy(),
                                              np.asarray(js[s][k]["q"]))
                np.testing.assert_allclose(ts[s][k]["scale"].numpy(),
                                           np.asarray(js[s][k]["scale"]),
                                           rtol=1e-6)
            else:
                assert ts[s][k].dtype == getattr(torch, state_dtype)
                np.testing.assert_allclose(
                    ts[s][k].float().numpy(),
                    np.asarray(js[s][k], np.float32), rtol=1e-6, atol=0)


def test_adamw_slices_large_leaves_without_changing_them(monkeypatch):
    """A float state leaf updated in slices of its leading axis equals the
    whole-leaf update bit for bit, and the inputs are left as they were."""
    rng = np.random.default_rng(4)
    p = {"w": torch.from_numpy(rng.standard_normal((6, 5, 7)).astype(
        np.float32))}
    g = {"w": torch.from_numpy(rng.standard_normal((6, 5, 7)).astype(
        np.float32))}
    cfg = A.AdamWConfig()
    st = A.adamw_init(p, cfg)
    before = p["w"].clone()
    whole = A.adamw_update(g, st, p, 1e-2, cfg)
    monkeypatch.setattr(A, "SLICE", 35)          # one row of 5 x 7
    sliced = A.adamw_update(g, st, p, 1e-2, cfg)
    assert torch.equal(whole[0]["w"], sliced[0]["w"])
    assert torch.equal(whole[1]["m"]["w"], sliced[1]["m"]["w"])
    assert torch.equal(whole[1]["v"]["w"], sliced[1]["v"]["w"])
    assert torch.equal(p["w"], before) and int(st["count"]) == 0
    assert not st["m"]["w"].any()


def test_adamw_weight_decay_only_on_matrices():
    cfg = A.AdamWConfig(weight_decay=0.1)
    p = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
    g = {"w": torch.zeros((2, 2)), "b": torch.zeros((2,))}
    newp, _ = A.adamw_update(g, A.adamw_init(p, cfg), p, 1.0, cfg)
    assert float(newp["w"][0, 0]) < 1.0
    assert float(newp["b"][0]) == 1.0


@pytest.mark.parametrize("n", [1, 128, 129, 1000])
def test_quantize_blockwise_bit_equal(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 2, n)).astype(
        np.float32)
    x[: min(n, 128) // 2] = 0.0          # an all-zero half block
    want = JA.quantize_blockwise(jnp.asarray(x))
    got = A.quantize_blockwise(torch.from_numpy(x))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    np.testing.assert_array_equal(
        A.dequantize_blockwise(got, (n,)).numpy(),
        np.asarray(JA.dequantize_blockwise(want, (n,))))


def test_cosine_schedule_and_clip_match_jax():
    jl, tl = JS.cosine_schedule(1e-3, 10, 100), S.cosine_schedule(1e-3, 10,
                                                                   100)
    for step in (0, 3, 9, 10, 11, 50, 99, 100, 140):
        assert abs(float(tl(step)) - float(jl(jnp.asarray(step)))) <= 1e-10
        assert abs(float(tl(torch.tensor(step, dtype=torch.int32)))
                   - float(jl(jnp.asarray(step)))) <= 1e-10
    rng = np.random.default_rng(5)
    g = {"a": (rng.standard_normal(10) * 10).astype(np.float32),
         "b": {"c": rng.standard_normal((3, 4)).astype(np.float32)}}
    for max_norm in (1.0, 1e3):
        cj, nj = JS.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                        max_norm)
        ct, nt = S.clip_by_global_norm(
            {"a": torch.from_numpy(g["a"]),
             "b": {"c": torch.from_numpy(g["b"]["c"])}}, max_norm)
        assert abs(float(nt) - float(nj)) <= 1e-6 * float(nj)
        np.testing.assert_allclose(ct["a"].numpy(), np.asarray(cj["a"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(ct["b"]["c"].numpy(),
                                   np.asarray(cj["b"]["c"]), rtol=1e-6)


def _to_torch_state(jst, cfg):
    params = params_from_numpy(jax.tree.map(np.asarray, jst.params), cfg,
                               device="cpu", param_dtype=torch.float32)
    return TrainState(params, A.adamw_init(params, A.AdamWConfig()),
                      torch.zeros((), dtype=torch.int32))


def test_three_train_steps_match_jax():
    """make_train_step (flash path, remat full) against JAX's jitted step
    on the same three numpy batches."""
    jcfg, cfg = _cfgs(scan_layers=False, use_pallas_attention=True,
                      remat="full")
    kw = dict(base_lr=1e-3, warmup=2, total_steps=10)
    jst = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    st = _to_torch_state(jst, cfg)
    jstep = jax.jit(jax_make_train_step(jcfg, **kw))
    step = make_train_step(cfg, **kw)
    for i in range(3):
        b = _batch(10 + i, B=4, S=16)
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        st, m = step(st, {k: torch.from_numpy(v) for k, v in b.items()})
        for name in ("loss", "grad_norm", "lr"):
            assert abs(m[name].item() - float(jm[name])) <= \
                LOSS_RTOL * abs(float(jm[name])), name
    assert st.step.item() == 3
    lr, flips, total = 1e-3, 0, 0
    for path in leaf_paths(st.params):
        diff = np.abs(get_path(st.params, path).numpy()
                      - np.asarray(get_path(jst.params, path)))
        assert diff.max() <= 2 * lr * 3, "/".join(path)
        flips += int((diff > 1e-5).sum())
        total += diff.size
    assert flips <= 1e-3 * total


def test_train_step_leaves_its_input_state_unchanged():
    _, cfg = _cfgs(scan_layers=False, use_pallas_attention=True)
    st = init_train_state(cfg, seed=0, device="cpu")
    snap = [t.clone() for t in _state_leaves(st)]
    new, _ = make_train_step(cfg)(st, {k: torch.from_numpy(v)
                                       for k, v in _batch(6).items()})
    assert all(torch.equal(a, b) for a, b in zip(_state_leaves(st), snap))
    assert not torch.equal(new.params["layers"]["attn"]["wq"],
                           st.params["layers"]["attn"]["wq"])


def _state_leaves(st):
    return tree.flatten(st)[0]


def test_step_frees_gradients_without_the_cycle_collector():
    """The tree helpers hold no reference cycle, so gradients are freed as
    soon as the step drops them (at full width one more fp32 copy of them,
    alive through AdamW, overflows an 80 GB card)."""
    _, cfg = _cfgs(scan_layers=False, use_pallas_attention=True)
    st = init_train_state(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(8).items()}
    was = gc.isenabled()
    gc.disable()
    try:
        _, _, grads = loss_and_grads(cfg, st.params, batch)
        refs = [weakref.ref(g) for g in tree.flatten(grads)[0]]
        clipped, _ = S.clip_by_global_norm(grads, 1.0)
        del grads
        assert all(r() is None for r in refs)
        refs = [weakref.ref(g) for g in tree.flatten(clipped)[0]]
        del clipped
        assert all(r() is None for r in refs)
    finally:
        if was:
            gc.enable()


def test_microbatches_match_one_batch():
    """Two microbatches of equal token counts give the same step as one
    batch, up to fp32 summation order."""
    _, cfg = _cfgs(scan_layers=False, use_pallas_attention=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(7, B=4).items()}
    st = init_train_state(cfg, seed=1, device="cpu")
    one, m1 = make_train_step(cfg)(st, batch)
    two, m2 = make_train_step(dataclasses.replace(cfg, microbatches=2))(
        st, batch)
    assert abs(m1["loss"].item() - m2["loss"].item()) <= 1e-6 * abs(
        m1["loss"].item())
    assert m2["tokens"].item() == batch["labels"].numel()
    for a, b in zip(_state_leaves(one), _state_leaves(two)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_weight_bridge_fp32_masters(weights):
    """Training holds fp32 masters; serving keeps the compute dtype; the
    masters cast to bf16 are the serving weights."""
    _, cfg = _cfgs()
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    masters = params_from_numpy(weights, bf16, device="cpu",
                                param_dtype=torch.float32)
    serving = params_from_numpy(weights, bf16, device="cpu")
    for path in leaf_paths(masters):
        m, s = get_path(masters, path), get_path(serving, path)
        assert m.dtype == torch.float32
        np.testing.assert_array_equal(m.numpy(), get_path(weights, path))
        if path[-1] == "scale":
            assert s.dtype == torch.float32
        else:
            assert s.dtype == torch.bfloat16
            assert torch.equal(m.to(torch.bfloat16), s)
    st = init_train_state(bf16, seed=0, device="cpu")
    own = M.init_params(bf16, seed=0, device="cpu")
    for path in leaf_paths(own):
        assert get_path(st.params, path).dtype == torch.float32
        assert torch.equal(get_path(st.params, path).to(get_path(own, path).dtype),
                           get_path(own, path))


def test_synthetic_lm_table_and_determinism():
    """The bigram table is the JAX package's (numpy recipe, fp32 softmax);
    batches are deterministic in (seed, step) and learnable."""
    d1, d2 = SyntheticLM(128, seed=3), SyntheticLM(128, seed=3)
    np.testing.assert_allclose(d1.table, JaxSyntheticLM(128, seed=3).table,
                               rtol=1e-5, atol=1e-9)
    b1, b2, b3 = d1.batch(7, 4, 16), d2.batch(7, 4, 16), d1.batch(8, 4, 16)
    assert b1["tokens"].dtype == torch.int32 and b1["tokens"].shape == (4,
                                                                       15)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert SyntheticLM(64, seed=0).entropy_floor() < np.log(64) * 0.8
    fn = make_batch_fn(get_config("granite-3-2b"),
                       ShapeConfig("t", 32, 2, "train"), seed=1)
    a, b = fn(5), fn(5)
    assert a["tokens"].shape == a["labels"].shape == (2, 32)
    assert torch.equal(a["tokens"], b["tokens"])
    assert int(a["tokens"].max()) < 49155
