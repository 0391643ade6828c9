"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests see 1 CPU device;
multi-device behaviour is tested via subprocess (test_multidevice.py,
test_sharded_serving.py) through :func:`run_child` below."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest

from repro.config import get_config, list_archs, reduced

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_child(code: str, devices: int = 8, preamble: str = "",
              timeout: int = 600) -> str:
    """Run a snippet in a child interpreter with ``devices`` forced host
    devices (the main test process must keep exactly 1 device).  The
    optional ``preamble`` is dedented separately, so shared setup and the
    per-test body can carry different indentation."""
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.path.join(REPO, "src"))
    src = textwrap.dedent(preamble) + textwrap.dedent(code)
    out = subprocess.run([sys.executable, "-c", src],
                         capture_output=True, text=True, env=env,
                         timeout=timeout)
    assert out.returncode == 0, f"child failed:\n{out.stdout}\n{out.stderr}"
    return out.stdout


@pytest.fixture(scope="session")
def archs():
    return list_archs()


def small_batch(cfg, B=2, S=16, key=0):
    k = jax.random.PRNGKey(key)
    ks = jax.random.split(k, 4)
    s_text = S - (cfg.n_image_tokens or 0)
    batch = {
        "tokens": jax.random.randint(ks[0], (B, s_text), 0, cfg.vocab),
        "labels": jax.random.randint(ks[1], (B, s_text), 0, cfg.vocab),
    }
    if cfg.n_image_tokens:
        batch["image_embeds"] = jax.random.normal(
            ks[2], (B, cfg.n_image_tokens, cfg.d_model), jnp.float32)
    if cfg.n_encoder_layers:
        batch["frames"] = jax.random.normal(
            ks[3], (B, cfg.encoder_seq, cfg.d_model), jnp.float32)
    return batch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); "
        "skips where torch.cuda.is_available() is false")
