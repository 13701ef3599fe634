"""Where `import rkmh_tpu` puts JAX's persistent compilation cache."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = "import rkmh_tpu, jax; print(jax.config.jax_compilation_cache_dir)"


def _cache_dir(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("value", ["/x", "/tmp/some cache"])
def test_env_cache_dir_is_left_alone(value):
    assert _cache_dir(value) == value


def test_default_cache_is_the_repo_dot_jax_cache():
    assert _cache_dir(None) == os.path.join(REPO, ".jax_cache")
