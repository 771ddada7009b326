"""Block-size and warp sweep of the Triton Gaussian sweep kernel on the GPU.

Times ``ops.fused_sweep.fused_gaussian_sweep`` alone (no orchestrator) at
each (chains per program, warps per program) pair and prints one JSON line
per chain count, medians of ``repeats``.  The fixed ``BLOCK`` and
``NUM_WARPS`` in ``ops/fused_sweep.py`` come from this sweep.

Usage: python tools/tune_gaussian_block.py [n_chains ...]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def time_kernel(m, steps, block, warps, repeats=5):
    from montecarlo_tpu.models import particle1d as p1d
    from montecarlo_tpu.ops.fused_sweep import fused_gaussian_sweep
    x = jnp.zeros((m,), jnp.float32)
    b = jnp.full((m,), 2.0, jnp.float32)

    def run():
        return fused_gaussian_sweep(x, b, 0.5, 7, 0, steps,
                                    potential=p1d.harmonic, block=block,
                                    num_warps=warps)
    jax.block_until_ready(run())
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def main():
    from montecarlo_tpu.utils.runtime import (gpu_line, require_gpu,
                                              setup_compile_cache)
    setup_compile_cache()
    dev = require_gpu()
    print(gpu_line())
    sizes = [int(a) for a in sys.argv[1:]] or [10_000, 100_000]
    for m in sizes:
        # calibrate the step count to ~0.2 s at the default configuration
        steps = 2000
        while time_kernel(m, steps, 64, 2, repeats=1) < 0.05:
            steps *= 4
        steps = int(steps * 0.2 / time_kernel(m, steps, 64, 2, repeats=1))
        rows = []
        for block in (32, 64, 128, 256, 512, 1024):
            for warps in (1, 2, 4, 8):
                if warps * 32 > block:
                    continue
                t = time_kernel(m, steps, block, warps)
                rows.append({"block": block, "num_warps": warps,
                             "programs": -(-m // block),
                             "steps_per_sec": m * steps / t})
        best = max(rows, key=lambda r: r["steps_per_sec"])
        print(json.dumps({"n_chains": m, "steps": steps, "device": dev,
                          "best": best, "rows": rows}))


if __name__ == "__main__":
    main()
