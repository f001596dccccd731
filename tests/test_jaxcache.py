"""Persistent compile cache location (utils/jaxcache.py): the
JAX_COMPILATION_CACHE_DIR environment variable when set, otherwise the
fixed <repo>/.jax_cache. Checked in a fresh interpreter, where nothing
has configured jax yet."""

import os
import subprocess
import sys

import pytest

from pansvr_tpu.utils.jaxcache import REPO_CACHE_DIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = (
    "import jax; from pansvr_tpu.utils.jaxcache import enable_cache;"
    "d = enable_cache(); print(d); print(jax.config.jax_compilation_cache_dir)"
)


@pytest.mark.parametrize("env_dir", ["set", "unset"])
def test_cache_dir(env_dir, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = REPO_CACHE_DIR
    if env_dir == "set":
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    resolved, configured = r.stdout.split()[-2:]
    assert resolved == configured == want
    if env_dir == "unset":
        assert want == os.path.join(REPO, ".jax_cache")
