"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR is honoured,
and the default is a fixed directory inside the checkout."""
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

PROBE = ("import jax, tpumap; "
         "print(jax.config.jax_compilation_cache_dir); "
         "from tpumap.utils import jaxcache; print(jaxcache.cache_dir())")


def _probe(**env_over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "TPUMAP_NO_JAX_CACHE")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), **env_over)
    r = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd="/",
                       capture_output=True, text=True, timeout=120,
                       check=True)
    return r.stdout.split()


def test_env_var_is_honoured(tmp_path):
    jax_dir, ours = _probe(JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert jax_dir == ours == str(tmp_path)


def test_default_is_fixed_inside_checkout():
    jax_dir, ours = _probe()
    assert jax_dir == ours == str(REPO / ".jax_cache")
    assert (REPO / ".jax_cache").is_dir()
