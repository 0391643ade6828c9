"""Training the hybrid-SSM, encoder-decoder and image-prefix families
(reduced hymba-1.5b, whisper-small and paligemma-3b: 2 layers, d 64,
fp32) in the port against the JAX package, on the same weights and numpy
batches.

The flash path follows JAX's rule: ``use_pallas_attention`` on the
unrolled stack, and never with an image prefix.  So hymba's self
attention (windowed on one layer of two) and whisper's encoder
(non-causal) and decoder run the flash op (its plain version on the CPU;
JAX's Pallas kernels in interpret mode), paligemma's and every cross
attention the plain path.

Tolerances as ``tests/test_torch_train.py``: loss 1e-5 relative,
gradients 1e-5 of each leaf's largest; two train steps: losses 1e-5
relative, params within 2 lr a step, at most 0.1 % of the entries past
1e-5 (AdamW's early steps move a weight by about lr whatever its
gradient's size, so a near-zero gradient of the other sign moves it the
other way).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SHAPES as JAX_SHAPES
from repro.config import get_config as jax_get_config
from repro.config import reduced as jax_reduced
from repro.data.pipeline import make_batch_fn as jax_make_batch_fn
from repro.models import model as JM
from repro.train.steps import init_train_state as jax_init_train_state
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.config import SHAPES, get_config, reduced
from repro_torch.core.tree import get_path, leaf_paths
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.optim import adamw as A
from repro_torch.train.steps import (TrainState, loss_and_grads,
                                     make_train_step)
from repro_torch.weights import params_from_numpy

ARCHS = ("hymba-1.5b", "whisper-small", "paligemma-3b")
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
# flash calls in one forward of the reduced stacks: a layer each, and
# whisper's encoder layers too; none under an image prefix
FLASH_CALLS = {"hymba-1.5b": 2, "whisper-small": 4, "paligemma-3b": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), **kw)
    cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """JAX's reduced init as numpy, the SSM's zero-initialised bias drawn
    (a gradient through it must not hide behind zeros)."""
    jcfg, _ = _cfgs(arch)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    if "ssm" in tree["layers"]:
        s = tree["layers"]["ssm"]
        s["dt_bias"] = (np.random.default_rng(2).standard_normal(
            s["dt_bias"].shape) * 0.5).astype(np.float32)
    return tree


def _batch(cfg, seed, B=2, S=12):
    """Text tokens and labels, plus image embeddings or audio frames."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.n_image_tokens:
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.n_encoder_layers:
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, flash, monkeypatch):
    """``M.loss_fn`` and its gradients on the unrolled stack (remat full)
    against ``jax.grad``; the flash op runs exactly where JAX's rule puts
    its kernel; no loss on the image prefix."""
    jcfg, cfg = _cfgs(arch, scan_layers=False, use_pallas_attention=flash,
                      remat="full")
    tree = _weights(arch)
    batch = _batch(cfg, 1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b), has_aux=True))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    calls = []
    real = fa_ops.attention_trainable

    def counting(*a, **kw):
        calls.append(kw.get("causal", True))
        return real(*a, **kw)

    monkeypatch.setattr(fa_ops, "attention_trainable", counting)
    params = params_from_numpy(tree, cfg, device="cpu",
                               param_dtype=torch.float32)
    loss, metrics, grads = loss_and_grads(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert metrics["tokens"].item() == int(jm["tokens"]) \
        == batch["labels"].size
    # remat full runs each layer's forward twice under a gradient
    assert len(calls) == (2 * FLASH_CALLS[arch] if flash else 0)
    if flash and cfg.n_encoder_layers:
        assert calls.count(False) == 2 * cfg.n_encoder_layers
    for path in leaf_paths(grads):
        want = np.asarray(get_path(jg, path))
        got = get_path(grads, path)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg="/".join(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_jax(arch):
    """``make_train_step`` (flash path, remat full) against JAX's jitted
    step on the same two numpy batches."""
    jcfg, cfg = _cfgs(arch, scan_layers=False, use_pallas_attention=True,
                      remat="full")
    kw = dict(base_lr=1e-3, warmup=2, total_steps=10)
    jst = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jst.params), cfg,
                               device="cpu", param_dtype=torch.float32)
    st = TrainState(params, A.adamw_init(params, A.AdamWConfig()),
                    torch.zeros((), dtype=torch.int32))
    jstep = jax.jit(jax_make_train_step(jcfg, **kw))
    step = make_train_step(cfg, **kw)
    for i in range(2):
        b = _batch(cfg, 10 + i, B=2, S=8)
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        st, m = step(st, {k: torch.from_numpy(v) for k, v in b.items()})
        for name in ("loss", "grad_norm", "lr"):
            assert abs(m[name].item() - float(jm[name])) <= \
                LOSS_RTOL * abs(float(jm[name])), name
    lr, flips, total = 1e-3, 0, 0
    for path in leaf_paths(st.params):
        diff = np.abs(get_path(st.params, path).numpy()
                      - np.asarray(get_path(jst.params, path)))
        assert diff.max() <= 2 * lr * 2, "/".join(path)
        flips += int((diff > 1e-5).sum())
        total += diff.size
    assert flips <= 1e-3 * total


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_fn_covers_modalities(arch):
    """As ``tests/test_optim_data.py::test_batch_fn_covers_modalities``:
    the text is the sequence less the image prefix, and the image
    embeddings and frames come in the compute dtype, with JAX's keys and
    shapes."""
    cfg = reduced(get_config(arch), dtype="bfloat16")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                global_batch=2)
    b = make_batch_fn(cfg, shape)(0)
    jb = jax_make_batch_fn(jax_reduced(jax_get_config(arch),
                                       dtype="bfloat16"),
                           dataclasses.replace(JAX_SHAPES["train_4k"],
                                               seq_len=16,
                                               global_batch=2))(0)
    assert set(b) == set(jb)
    for k, v in b.items():
        assert tuple(v.shape) == jb[k].shape, k
    assert b["tokens"].shape == (2, 16 - cfg.n_image_tokens)
    assert b["tokens"].dtype == torch.int32
    for k in ("image_embeds", "frames"):
        if k in b:
            assert b[k].dtype == torch.bfloat16
    again = make_batch_fn(cfg, shape)(0)
    assert all(torch.equal(b[k], again[k]) for k in b)


@pytest.mark.parametrize("arch", ["whisper-small", "paligemma-3b"])
def test_train_launcher_passes_the_extra_inputs(arch, tmp_path, capsys,
                                              monkeypatch):
    """The launcher through the verbs on the CPU: every step's loss sees
    the text chain beside random frames or image embeddings, as the JAX
    launcher's does."""
    seen = []
    real = M.loss_fn

    def recording(cfg, params, batch, **kw):
        seen.append(sorted(batch))
        return real(cfg, params, batch, **kw)

    monkeypatch.setattr(M, "loss_fn", recording)
    rep = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--d-model", "64", "--n-layers", "2", "--vocab",
                          "64", "--steps", "3", "--batch", "2", "--seq",
                          "8", "--checkpoint-every", "2", "--workspace",
                          str(tmp_path), "--pallas-attention"])
    capsys.readouterr()
    assert rep["steps"] == 3 and np.isfinite(rep["last_loss"])
    assert [a["completed"] for a in rep["attempts"]] == [True]
    extra = "frames" if arch == "whisper-small" else "image_embeds"
    assert seen == [sorted(["tokens", "labels", extra])] * 3
