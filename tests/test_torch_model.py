"""The port's model (``repro_torch.models.model``), weight bridge and greedy
oracle (``repro_torch.launch.serve.generate``) against the JAX package's,
for reduced gemma-2b and granite-3-2b, on the same weights.

Tolerances: bridge round trip exact; stack logits 1e-4 relative (fp32,
two layers of sums in another order); generated tokens identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import reduced as jax_reduced
from repro.launch.serve import generate as jax_generate
from repro.models import model as JM
from repro.models.layers import logits_from_hidden as jax_logits
from repro_torch.config import get_config, reduced
from repro_torch.launch.serve import generate
from repro_torch.models import model as M
from repro_torch.models.layers import logits_from_hidden
from repro_torch.weights import params_from_numpy, params_to_numpy

ARCHS = ["gemma-2b", "granite-3-2b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg = jax_reduced(jax_get_config(arch))
        cfg = reduced(get_config(arch))
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jp)
        out[arch] = (jcfg, jp, tree, cfg,
                     params_from_numpy(tree, cfg, device="cpu"))
    return out


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_bridge_round_trip(models, arch):
    """Same tree, same (in, out) layout, same values; and the port's own
    init draws the same shapes."""
    _, _, tree, cfg, params = models[arch]
    back = dict(_leaves(params_to_numpy(params)))
    want = dict(_leaves(tree))
    assert back.keys() == want.keys()
    for name, arr in want.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    own = dict(_leaves(M.init_params(cfg, seed=0, device="cpu")))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in want.items()}
    assert M.count_params(cfg) == sum(v.size for v in want.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(models, arch):
    jcfg, jp, _, cfg, params = models[arch]
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 13),
                                             dtype=np.int32)
    jh, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    want = np.asarray(jax_logits(jp, jh, jcfg))[..., :cfg.vocab]
    with torch.no_grad():
        h = M.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
        got = logits_from_hidden(params, h, cfg).numpy()[..., :cfg.vocab]
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_token_identical_to_jax(models, arch):
    jcfg, jp, _, cfg, params = models[arch]
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (2, 6),
                                                dtype=np.int32)
    want = np.asarray(jax_generate(jcfg, jp, jnp.asarray(prompts), 7))
    got, top2 = generate(cfg, params, torch.from_numpy(prompts), 7,
                         return_top2=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert top2.shape == (2, 7, 2) and (top2[..., 0] >= top2[..., 1]).all()


def test_entry_points_raise_without_a_gpu_unless_cpu_is_asked():
    """No silent CPU fallback: the default device is cuda."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    cfg = reduced(get_config("granite-3-2b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(cfg)
    assert M.init_params(cfg, device="cpu")["embed"]["table"].device.type \
        == "cpu"
