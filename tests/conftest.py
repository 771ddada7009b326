"""Test config: force an 8-device virtual CPU mesh before JAX import.

Mirrors SURVEY §4's recommendation: run the statistical tiers on CPU and
exercise the multi-device sharding path with
``--xla_force_host_platform_device_count``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent compilation cache: the PGMC advance body takes ~70s to compile
# on the CPU backend; caching makes reruns near-instant.
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(os.path.dirname(__file__), "..",
                                   ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
