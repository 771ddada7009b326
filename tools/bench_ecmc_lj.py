"""Soft-potential ECMC benchmark: LJ event throughput + equal-wall-clock
ESS vs Metropolis (VERDICT r4 item 5's events/s / ESS/s artifact).

Measures through the production engine path:

1. Raw lifting-event throughput of the LJ straight event chain
   (collisions/s/chip).
2. Sampling efficiency: integrated autocorrelation time of e/N for ECMC
   and for Metropolis local displacements, as effective samples per second
   of wall clock.
3. The MKK pressure estimator vs the configurational virial (a free
   correctness cross-check on the benchmark config itself).

Usage: python tools/bench_ecmc_lj.py [n_chains] [rho]
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N_PART = 64
STEPS = 300
ELL = 1.5


def bench_events(m, rho):
    import montecarlo_tpu as mc
    from montecarlo_tpu.core.simulation import _select_advance
    from montecarlo_tpu.models import lennard_jones as lj

    chains = lj.init_chains(m, N_PART, rho=rho, beta=1.0, frac_b=0.0,
                            seed=42)
    sim = mc.Simulation(
        lj.make_system(), chains,
        [dict(algorithm=mc.EventChain,
              model=lj.ecmc_model(ELL, max_events_per_chain=512),
              events_per_step=8, seed=7)],
        STEPS, path="/tmp/mctpu_ecmc_lj_bench")
    ds = sim.init_device_state()
    masks = tuple(jnp.ones(sim.steps + 1, bool) for _ in sim.device_algos)
    adv = jax.jit(_select_advance(sim))
    out = adv(ds, masks, STEPS)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = adv(ds, masks, STEPS)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    stats = out["ecmc"]["stats"]
    ncoll = int(np.asarray(stats["collisions"]).sum())
    cap = int(np.asarray(stats["cap_hits"]).sum())
    excess = float(np.asarray(stats["excess"], np.float64).sum())
    nch = float(np.asarray(stats["chains"], np.float64).sum())
    p_ecmc = 1.0 + excess / (nch * ELL)
    from montecarlo_tpu.models import lennard_jones as lj2
    pv = float(np.mean(np.asarray(jax.vmap(
        lambda s: lj2.virial_pressure(s))(out["sys"]))))
    return ncoll / best, ncoll, cap, best, p_ecmc, pv / rho


def series_run(m, rho, algo_spec, path):
    import montecarlo_tpu as mc
    from montecarlo_tpu.models import lennard_jones as lj

    chains = lj.init_chains(m, N_PART, rho=rho, beta=1.0, frac_b=0.0,
                            seed=42)
    sim = mc.Simulation(
        lj.make_system(), chains,
        [algo_spec,
         dict(algorithm=mc.StoreCallbacks,
              callbacks=(lj.callback_energy_per_particle,),
              scheduler=np.arange(1, STEPS + 1))],
        STEPS, path=path)
    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0
    d = np.loadtxt(os.path.join(path, "energy_per_particle.dat"))
    burn = STEPS // 3
    return d[d[:, 0] > burn, 1], wall


def main():
    import montecarlo_tpu as mc
    from montecarlo_tpu.models import lennard_jones as lj
    from montecarlo_tpu.utils.analysis import integrated_autocorr_time

    m = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    rho = float(sys.argv[2]) if len(sys.argv) > 2 else 0.6

    ev_s, ncoll, cap, wall, p_ecmc, p_vir = bench_events(m, rho)
    print(f"LJ ECMC events/s: {ev_s / 1e6:.3f} M (collisions={ncoll}, "
          f"cap_hits={cap}, wall={wall:.3f}s)", file=sys.stderr)
    print(f"pressure: MKK estimator beta P/rho = {p_ecmc:.3f} vs "
          f"virial {p_vir:.3f}", file=sys.stderr)

    s_e, w_e = series_run(
        m, rho,
        dict(algorithm=mc.EventChain,
             model=lj.ecmc_model(ELL, max_events_per_chain=512),
             events_per_step=8, seed=7),
        "/tmp/mctpu_ecmc_lj_series")
    s_m, w_m = series_run(
        m, rho,
        dict(algorithm=mc.Metropolis,
             pool=(lj.lj_displacement_move(0.25),), sweepstep=N_PART,
             seed=7),
        "/tmp/mctpu_mh_lj_series")
    tau_e = integrated_autocorr_time(s_e)
    tau_m = integrated_autocorr_time(s_m)
    ess_s_e = (len(s_e) / tau_e) / w_e
    ess_s_m = (len(s_m) / tau_m) / w_m
    print(f"ECMC: tau={tau_e:.2f} steps, wall={w_e:.2f}s -> "
          f"{ess_s_e:.2f} ESS/s", file=sys.stderr)
    print(f"MH:   tau={tau_m:.2f} steps, wall={w_m:.2f}s -> "
          f"{ess_s_m:.2f} ESS/s", file=sys.stderr)
    print(json.dumps({
        "metric": "lj_soft_ecmc",
        "n_particles": N_PART, "n_chains": m, "rho": rho,
        "events_per_sec": round(ev_s),
        "cap_hits": cap,
        "pressure_mkk_vs_virial": [round(p_ecmc, 3), round(p_vir, 3)],
        "e_tau_ecmc_steps": round(tau_e, 2),
        "e_tau_mh_steps": round(tau_m, 2),
        "ess_per_sec_ecmc": round(ess_s_e, 2),
        "ess_per_sec_mh": round(ess_s_m, 2),
        "ecmc_vs_mh_x": round(ess_s_e / ess_s_m, 2),
    }))


if __name__ == "__main__":
    main()
