"""Where importing graphaudio_tpu puts JAX's persistent compilation cache.

Each case runs in a fresh interpreter: the cache directory is chosen once,
at import, before any test configured JAX in this process.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import jax, jax.numpy as jnp
import graphaudio_tpu
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.jit(lambda x: x * 2.0 + 1.0)(jnp.ones(7)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
"""


def _probe(tmp_path, **env_extra):
    env = {
        k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"
    }
    env.update(
        JAX_PLATFORMS="cpu",
        PYTHONPATH=REPO,
        HOME=str(tmp_path / "home"),
        XDG_CACHE_HOME=str(tmp_path / "xdg"),
        **env_extra,
    )
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()[-1]


def test_import_honours_jax_compilation_cache_dir(tmp_path):
    cache = tmp_path / "cache"
    assert _probe(tmp_path, JAX_COMPILATION_CACHE_DIR=str(cache)) == str(cache)
    assert any(cache.iterdir()), "nothing was cached in JAX_COMPILATION_CACHE_DIR"
    assert not (tmp_path / "home").exists()
    assert not (tmp_path / "xdg").exists()


def test_cache_defaults_to_fixed_path_in_checkout(tmp_path):
    assert _probe(tmp_path) == os.path.join(REPO, ".jax_cache")
    assert not (tmp_path / "home").exists()
    assert not (tmp_path / "xdg").exists()
