"""Entry-point scripts: the compile-cache placement and the refusal to run
without a GPU.

Each case runs in a subprocess, so no JAX configuration leaks into the
test process.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_COMPILATION_CACHE_DIR")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


@pytest.mark.parametrize("preset", [False, True], ids=["unset", "set"])
def test_compile_cache_placement(tmp_path, preset):
    """Unset: the cache goes to ``<repo>/.jax_cache``.  Set: the variable
    wins and the helper sets nothing."""
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if preset else {}
    code = ("import jax; from montecarlo_tpu.utils.runtime import "
            "setup_compile_cache as s; print(s()); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_env(**extra), capture_output=True, text=True,
                         timeout=120, check=True).stdout.split("\n")
    want = str(tmp_path) if preset else os.path.join(REPO, ".jax_cache")
    # set, JAX reads the variable itself; unset, the helper wrote the config
    assert out[0] == out[1] == want


@pytest.mark.parametrize("script,alone", [
    ("chip_smoke.py", False), ("chip_smoke.py", True), ("bench.py", False)],
    ids=["chip_smoke", "chip_smoke-alone", "bench"])
def test_script_fails_without_gpu(tmp_path, script, alone):
    """On a CPU-only host, or in a directory holding the script and nothing
    else of the repo, the script exits non-zero and prints no result."""
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, script), tmp_path)
        cwd = str(tmp_path)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
