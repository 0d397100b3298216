"""The persistent compilation cache directory: JAX_COMPILATION_CACHE_DIR
verbatim when set, else the fixed in-checkout path."""

import os
import subprocess
import sys

from acoustid_index.utils import jaxsetup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_is_used_verbatim():
    assert jaxsetup.compilation_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) == "/x/y"


def test_default_is_the_checkout_cache():
    assert jaxsetup.compilation_cache_dir({}) == os.path.join(ROOT, ".jax_cache")
    assert jaxsetup.compilation_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == os.path.join(ROOT, ".jax_cache")


def _configured_dir(env_extra, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    code = (
        "import jax, acoustid_index.ops; "
        "print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_process_config_follows_env(tmp_path):
    want = str(tmp_path / "cache")
    assert _configured_dir({"JAX_COMPILATION_CACHE_DIR": want}) == want
    assert _configured_dir({}, drop=("JAX_COMPILATION_CACHE_DIR",)) == os.path.join(ROOT, ".jax_cache")
