"""Headline benchmark: Metropolis steps/s at 10^4 particle-1d chains on a GPU.

Times the production time-stepper (``core.simulation._select_advance``, the
compiled loop ``Simulation.run`` executes between sync points) on the
flagship workload: particle-1d harmonic, beta=2, one Gaussian displacement
move.  With ``fused='auto'`` on a GPU that is the Triton sweep kernel; with
``--fused off`` it is what XLA makes of the generic ``mc_sweep``.

The segment length is calibrated by a short run to about ``--seconds`` per
repeat, and the rate is the median of ``--repeats`` runs, each ended by
``jax.block_until_ready``.  The compile time (first call minus a timed call)
is reported as set-up.  There is no CPU fallback: without a GPU it exits
non-zero.

Usage:
  python bench.py                      # headline, one JSON line
  python bench.py --chains 100000 --fused off
  python bench.py --compare            # Triton vs XLA at 10^4 and 10^5
                                       # chains, same step count

Every JSON line carries the device as JAX reports it; the line before the
first carries ``nvidia-smi``'s name and power limit.
"""

import argparse
import json
import tempfile
import time

import jax
import jax.numpy as jnp

from montecarlo_tpu.utils.runtime import (gpu_line, require_gpu,
                                          setup_compile_cache)


def make_advance(n_chains, fused):
    """The jitted production stepper for the flagship workload, its initial
    device state and a name for the stepper it selected."""
    import montecarlo_tpu as mc
    from montecarlo_tpu.core.simulation import _select_advance
    from montecarlo_tpu.models import particle1d as p1d

    chains = p1d.init_chains(n_chains, beta=2.0, seed=42)
    sim = mc.Simulation(
        p1d.make_system(p1d.harmonic), chains,
        [dict(algorithm=mc.Metropolis, pool=(p1d.displacement_move(0.5),),
              seed=42, fused=fused)],
        1, path=tempfile.mkdtemp(prefix="mctpu_bench_"))
    stepper = ("triton_sweep" if sim.device_algos[0].supports_fused
               else "generic")
    ds = sim.init_device_state()
    # one always-on algorithm: neither stepper reads the schedule masks, so
    # the step count stays a traced argument (no recompilation per length)
    masks = (jnp.ones(2, bool),)
    advance = jax.jit(_select_advance(sim))
    return (lambda n: advance(ds, masks, n)), stepper


def time_steps(run, n_steps, repeats):
    """Median and relative spread of ``repeats`` timed runs."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run(n_steps))
        times.append(time.perf_counter() - t0)
    times.sort()
    median = times[len(times) // 2]
    return median, (times[-1] - times[0]) / median


def calibrate(run, seconds):
    """A step count that takes about ``seconds`` per run."""
    n = 256
    while True:
        t, _ = time_steps(run, n, 1)
        if t > 0.05 or n >= 2 ** 28:
            break
        n *= 4
    return max(1, min(int(n * seconds / t), 2 ** 30))


def bench(n_chains, fused, seconds, repeats, n_steps=None):
    run, stepper = make_advance(n_chains, fused)
    t0 = time.perf_counter()
    jax.block_until_ready(run(16))
    first = time.perf_counter() - t0
    warm, _ = time_steps(run, 16, 3)
    if n_steps is None:
        n_steps = calibrate(run, seconds)
    median, spread = time_steps(run, n_steps, repeats)
    return {"n_chains": n_chains, "fused": fused, "stepper": stepper,
            "n_steps": n_steps, "seconds_median": median,
            "steps_per_sec": n_chains * n_steps / median,
            "spread": spread, "compile_s": first - warm}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chains", type=int, default=10_000)
    ap.add_argument("--fused", default="auto", choices=("auto", "off"))
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--compare", action="store_true")
    args = ap.parse_args()

    setup_compile_cache()
    device = require_gpu()
    print(gpu_line(), flush=True)
    if not args.compare:
        r = bench(args.chains, args.fused, args.seconds, args.repeats)
        print(json.dumps({
            "metric": "metropolis_steps_per_sec",
            "value": r["steps_per_sec"], "unit": "steps/s", **r,
            "device": device}))
        return
    for n_chains in (10_000, 100_000):
        # same step count for both: sized on the slower (XLA) stepper
        xla = bench(n_chains, "off", args.seconds, args.repeats)
        tri = bench(n_chains, "auto", args.seconds, args.repeats,
                    n_steps=xla["n_steps"])
        print(json.dumps({
            "metric": "triton_vs_xla_steps_per_sec", "n_chains": n_chains,
            "triton": tri, "xla": xla,
            "speedup": tri["steps_per_sec"] / xla["steps_per_sec"],
            "device": device}))


if __name__ == "__main__":
    main()
