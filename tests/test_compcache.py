"""Persistent compilation cache (utils/compcache.py): the directory rule —
JAX_COMPILATION_CACHE_DIR when it is set, else the fixed <repo>/.jax_cache
— as a fresh process sees it after importing the package."""

import os
import subprocess
import sys

from depth_estimation_tpu.utils import compcache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import jax, jax.numpy as jnp
import depth_estimation_tpu
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
print(jax.config.jax_compilation_cache_dir)
jax.jit(lambda x: jnp.tanh(x) @ x.T + 3.25)(jnp.ones((64, 64))).block_until_ready()
"""


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_cache_entries_written(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache in
    use and receives the entries."""
    d = str(tmp_path / "xla-cache")
    assert _probe(d) == d
    assert any(n.endswith("-cache") for n in os.listdir(d))


def test_cache_dir_default_without_env():
    assert _probe(None) == compcache.DEFAULT_DIR
    assert compcache.DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")


def test_cache_dir_rule(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compcache.cache_dir() == compcache.DEFAULT_DIR
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert compcache.cache_dir() == "/some/where"
