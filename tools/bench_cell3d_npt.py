"""Cell-MC speedup gates: 3-D LJ and polydisperse NPT (VERDICT r4 items 3-4).

Measures attempted moves/s through the PRODUCTION engine advance for

1. 3-D LJ, N=4096: generic O(N)-row path (fused='off') vs the 3-D
   checkerboard cell path (27-neighbourhood rolls).  Gate: cell > 5x.
2. Polydisperse NPT (displacement + swap + volume pool), N=2048: generic
   path vs the fractional-coordinate cell path with volume substeps.
   Gate: cell > 3x.

Usage: python tools/bench_cell3d_npt.py [n_chains]
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def engine_rate(sim, n_steps, repeats=3):
    from montecarlo_tpu.core.simulation import _select_advance

    ds = sim.init_device_state()
    masks = tuple(jnp.ones(sim.steps + 1, bool) for _ in sim.device_algos)
    adv = jax.jit(_select_advance(sim))
    out = adv(ds, masks, n_steps)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = adv(ds, masks, n_steps)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    met = sim.device_algos[0]
    cnt = np.asarray(out[met.state_key]["counters"])
    attempts = int(cnt[..., 1].sum())
    if attempts == 0:   # generic path counters count every proposal
        attempts = sim.n_chains * n_steps * met.sweepstep
    return attempts / best, best, cnt


def bench_lj3d(m):
    import montecarlo_tpu as mc
    from montecarlo_tpu.models import lennard_jones as lj

    N = 4096
    chains = lj.init_chains(m, N, rho=1.0, beta=1.0 / 0.45, frac_b=0.2,
                            seed=42, dim=3)
    out = {}
    for mode, sweep, steps in (("off", 64, 4), ("cell", 512, 16)):
        sim = mc.Simulation(
            lj.make_system(), chains,
            [dict(algorithm=mc.Metropolis,
                  pool=(lj.lj_displacement_move(0.06),), seed=7,
                  sweepstep=sweep, fused=mode)],
            steps, path=f"/tmp/mctpu_lj3d_{mode}")
        met = sim.device_algos[0]
        if mode == "cell":
            assert met._use_cell, met._cell_plan_error
            print(f"3-D plan: {met._cell_plan!r}", file=sys.stderr)
        r, wall, cnt = engine_rate(sim, steps)
        acc = cnt[..., 0].sum() / max(cnt[..., 1].sum(), 1)
        print(f"lj3d {mode}: {r / 1e6:.3f} M moves/s (wall {wall:.3f}s, "
              f"acc {acc:.3f})", file=sys.stderr)
        out[mode] = round(r)
    out["speedup_x"] = round(out["cell"] / out["off"], 2)
    return out


def bench_poly_npt(m):
    import montecarlo_tpu as mc
    from montecarlo_tpu.models import polydisperse as poly

    N, P = 2048, 4.0
    chains = poly.init_chains(m, N, rho=1.0, beta=1.0 / 0.4, seed=42)
    pool = (poly.displacement_move(0.08, weight=0.75),
            poly.swap_move(weight=0.2),
            poly.volume_move(dlnv=0.002, pressure=P, weight=0.05))
    out = {}
    for mode, sweep, steps in (("off", 64, 4), ("auto", 512, 16)):
        sim = mc.Simulation(
            poly.make_system(), chains,
            [dict(algorithm=mc.Metropolis, pool=pool, seed=7,
                  sweepstep=sweep, fused=mode)],
            steps, path=f"/tmp/mctpu_polynpt_{mode}")
        met = sim.device_algos[0]
        if mode == "auto":
            assert met._use_cell, met._cell_plan_error
            print(f"NPT plan: {met._cell_plan!r}", file=sys.stderr)
        r, wall, cnt = engine_rate(sim, steps)
        print(f"poly NPT {mode}: {r / 1e6:.3f} M moves/s "
              f"(wall {wall:.3f}s, vol att {cnt[:, 2, 1].sum()}, "
              f"vol acc {cnt[:, 2, 0].sum()})", file=sys.stderr)
        out["cell" if mode == "auto" else mode] = round(r)
    out["speedup_x"] = round(out["cell"] / out["off"], 2)
    return out


def main():
    m = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    res = {"metric": "cell_mc_3d_and_npt_speedups", "n_chains": m,
           "lj3d_n4096_moves_per_sec": bench_lj3d(m),
           "poly_npt_n2048_moves_per_sec": bench_poly_npt(m)}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
