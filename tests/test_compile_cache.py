"""Where the persistent compilation cache lives."""

import os
import subprocess
import sys

import jax

import ganon_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_defaults_inside_checkout():
    assert ganon_tpu.compile_cache_dir({}) == os.path.join(REPO, ".jax_cache")
    # an empty variable counts as unset
    assert ganon_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": ""}) == os.path.join(REPO, ".jax_cache")


def test_cache_dir_follows_env_var():
    env = {"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}
    assert ganon_tpu.compile_cache_dir(env) == "/elsewhere/cache"


def test_import_configures_jax_cache(tmp_path):
    """In this process (no variable set by the suite) JAX caches in the
    checkout; in a child with the variable set, JAX keeps its own value
    and the package overrides nothing."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            REPO, ".jax_cache")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, ganon_tpu; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path)
