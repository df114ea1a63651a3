"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR wins; otherwise one
fixed, git-ignored directory inside the checkout."""

import os
import subprocess
import sys

from nvfpcc_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_dir_is_fixed_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_env_dir_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def _enable_in_child(env):
    code = (
        "import jax, jax.numpy as jnp\n"
        "from nvfpcc_tpu.utils.cache import enable_compilation_cache\n"
        "d = enable_compilation_cache()\n"
        "jax.jit(lambda x: jnp.sin(x) + 1)(jnp.ones(3)).block_until_ready()\n"
        "print(d)\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, check=True, timeout=300,
    ).stdout.split()
    return out[-2:]


def test_cache_lands_in_env_dir(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    assert _enable_in_child(env) == [str(tmp_path), str(tmp_path)]
    assert os.listdir(tmp_path), "no cache entry was written"


def test_default_dir_set_without_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("XLA_FLAGS", None)
    want = os.path.join(REPO, ".jax_cache")
    assert _enable_in_child(env) == [want, want]
