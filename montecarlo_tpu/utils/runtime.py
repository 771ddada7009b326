"""Process set-up shared by the entry-point scripts (``bench.py``,
``chip_smoke.py``, ``tools/*``): the persistent compile cache and the
accelerator check.

Both are explicit calls, never import side effects, so the library itself
touches no global JAX configuration.
"""

from __future__ import annotations

import os
import subprocess

import jax

__all__ = ["setup_compile_cache", "require_gpu", "gpu_line"]

#: the checkout this package lives in
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins and is left alone (JAX
    reads it itself).  Otherwise the cache goes to ``<repo>/.jax_cache``: a
    fixed path, because the path is part of the cache key.  Returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_line() -> str:
    """``name, power.limit`` of every visible card, as ``nvidia-smi`` reports
    them (one line per card), or a note when ``nvidia-smi`` is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.strip()


def require_gpu(count: int = 1) -> dict:
    """Fail unless JAX's default backend is a GPU with at least ``count``
    devices.  Returns ``{"platform", "kind", "count"}`` as JAX reports them.
    There is no CPU fallback: a measurement taken elsewhere is not one."""
    try:
        devs = jax.devices()
    except RuntimeError as e:
        raise SystemExit(f"no accelerator: {e}") from e
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {devs[0].platform!r}")
    if len(devs) < count:
        raise SystemExit(f"need {count} GPUs, JAX sees {len(devs)}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
