"""Smoke run of the main path on one GPU (or four, with ``--four-cards``).

Phases, each printed as one line and each fatal to the exit code:

  a. the device: JAX's default backend must be a GPU (no CPU fallback);
     prints ``nvidia-smi``'s name and power limit;
  b. the flagship through ``Simulation.run``: particle-1d harmonic, 10^4
     chains, beta=2, ``Metropolis(fused='auto')`` (the Triton sweep kernel),
     StoreCallbacks (energy, acceptance), BIN trajectories and a
     StoreBackups checkpoint;
  c. the Triton kernel against the plain reference (the generic XLA path,
     ``fused='off'``) at 10^4 chains: moments and acceptance within a stated
     number of standard errors, attempt counters exact;
  d. BASELINE config 5 on the generic path: Kob–Andersen LJ N=1024, 64
     chains, displacement + swap pool with PGMC (VPG) adapting sigma;
  e. the cell path: 2-D LJ at N=16384, 32 chains, cell MC selected by
     ``fused='auto'``;
  f. only with ``--four-cards``: the PGMC + recorders + checkpoint stack at
     10^4 chains over a 4-GPU chain mesh, bitwise against one card, and the
     sharded Triton kernel against the one-card kernel.  With the option no
     other phase runs.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``, printed only when
every phase passed.

Usage: python chip_smoke.py [--four-cards]
"""

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import montecarlo_tpu as mc  # noqa: E402
from montecarlo_tpu import policy_guided as pg  # noqa: E402
from montecarlo_tpu.core.simulation import _select_advance  # noqa: E402
from montecarlo_tpu.models import lennard_jones as lj  # noqa: E402
from montecarlo_tpu.models import particle1d as p1d  # noqa: E402
from montecarlo_tpu.utils.runtime import (gpu_line, require_gpu,  # noqa: E402
                                          setup_compile_cache)

BETA = 2.0
#: standard errors allowed between two independent estimates of a moment
N_SE = 5.0


def _tmp(name):
    return tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")


def _bare_advance(sim, ds, n_steps):
    """The production stepper ``Simulation.run`` compiles, without the
    recorder refresh: the cached energies it returns are the incremental
    ones."""
    masks = tuple(jnp.ones(sim.steps + 1, bool) for _ in sim.device_algos)
    out = jax.jit(_select_advance(sim))(ds, masks, n_steps)
    return jax.block_until_ready(out)


def _timed(fn, repeats=5):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


# -- b. flagship -------------------------------------------------------------

def phase_flagship(n_chains=10_000, steps=200_000, stride=1_000,
                   fused="auto"):
    path = _tmp("flagship")
    sched = np.arange(stride, steps + 1, stride)
    sim = mc.Simulation(
        p1d.make_system(p1d.harmonic), p1d.init_chains(n_chains, BETA, 42),
        [dict(algorithm=mc.Metropolis, pool=(p1d.displacement_move(0.5),),
              seed=42, fused=fused),
         dict(algorithm=mc.StoreCallbacks,
              callbacks=(p1d.callback_energy, mc.callback_acceptance),
              scheduler=sched),
         dict(algorithm=mc.StoreTrajectories, fmt=mc.BIN(),
              scheduler=sched[9::10]),
         dict(algorithm=mc.StoreBackups, scheduler=np.asarray([steps // 2]))],
        steps, path=path)
    met = sim.device_algos[0]
    assert met.supports_fused, "the Triton sweep kernel was not selected"
    assert "_select_advance" in _select_advance(sim).__qualname__, \
        "the flagship did not get the kernel's stepper"
    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0

    # tolerances: N_SE standard errors of one frame's chain average (later
    # frames only add samples); at beta=2, x ~ N(0, 1/4) and U = x^2 has
    # mean 1/4, std sqrt(2)/4
    se_e = np.sqrt(2) / 4 / np.sqrt(n_chains)
    se_std = 0.5 / np.sqrt(2 * n_chains)
    e = np.loadtxt(os.path.join(path, "energy.dat"))
    e_tail = e[e[:, 0] > steps // 2, 1].mean()
    assert abs(e_tail - 1 / (2 * BETA)) < N_SE * se_e, f"energy {e_tail}"
    ts, fields = mc.load_chain_major_trajectories(path)
    x_tail = np.asarray(fields["frame"])[ts > steps // 2]
    assert abs(x_tail.std() - 1 / np.sqrt(2 * BETA)) < N_SE * se_std, \
        f"position std {x_tail.std()}"
    acc = np.loadtxt(os.path.join(path, "acceptance.dat"))[-1, 1]
    assert 0.05 < acc < 0.99, f"acceptance {acc}"
    sys_state = sim.device_state["sys"]
    np.testing.assert_allclose(np.asarray(sys_state.e),
                               np.asarray(p1d.harmonic(sys_state.x)),
                               rtol=1e-6, err_msg="cached energy")
    ckpt = os.path.join(path, "checkpoints", f"ckpt_t{steps // 2}.npz")
    restored = mc.checkpoint.restore(ckpt, sim.init_device_state())
    assert int(restored["t"]) == steps // 2
    return (f"{n_chains} chains x {steps} steps through Simulation.run in "
            f"{wall:.2f} s (compile included); E tail {e_tail:.4f}, "
            f"x std {x_tail.std():.4f}, acceptance {acc:.4f}")


# -- c. kernel vs plain reference ------------------------------------------

def _p1d_advance(n_chains, steps, fused):
    sim = mc.Simulation(
        p1d.make_system(p1d.harmonic), p1d.init_chains(n_chains, BETA, 3),
        [dict(algorithm=mc.Metropolis, pool=(p1d.displacement_move(0.5),),
              seed=11, fused=fused)], steps, path=_tmp("p1d"))
    out = _bare_advance(sim, sim.init_device_state(), steps)
    return (np.asarray(out["sys"].x), np.asarray(out["sys"].e),
            np.asarray(out["metropolis"]["counters"])[:, 0, :])


def _moments(x, cnt):
    m = x.shape[0]
    acc = cnt[:, 0] / cnt[:, 1]
    return {"mean": (x.mean(), x.std() / np.sqrt(m)),
            "std": (x.std(), x.std() / np.sqrt(2 * m)),
            "acc": (acc.mean(), acc.std() / np.sqrt(m))}


def phase_kernel_vs_reference(n_chains=10_000, steps=4_000, fused="auto"):
    x_k, e_k, c_k = _p1d_advance(n_chains, steps, fused)
    x_r, e_r, c_r = _p1d_advance(n_chains, steps, "off")
    for c in (c_k, c_r):
        np.testing.assert_array_equal(c[:, 1], steps)
        assert np.all((0 <= c[:, 0]) & (c[:, 0] <= c[:, 1]))
    np.testing.assert_allclose(e_k, x_k * x_k, rtol=1e-6)
    mk, mr = _moments(x_k, c_k), _moments(x_r, c_r)
    parts = []
    for key in ("mean", "std", "acc"):
        (a, sa), (b, sb) = mk[key], mr[key]
        z = abs(a - b) / np.hypot(sa, sb)
        assert z < N_SE, f"{key}: kernel {a} vs reference {b} ({z:.1f} se)"
        parts.append(f"{key} {a:.4f}/{b:.4f} ({z:.1f} se)")
    assert abs(mk["std"][0] - 1 / np.sqrt(2 * BETA)) < N_SE * mk["std"][1]
    return (f"kernel/reference at {n_chains} chains x {steps} steps: "
            + ", ".join(parts) + "; counters exact")


# -- d. config 5 -------------------------------------------------------------

def phase_config5(n_chains=64, n=1024, steps=2_000, time_steps=500):
    params = lj.LJParams()
    chains = lj.init_chains(n_chains, n, rho=1.2, beta=1.0 / 0.45,
                            frac_b=0.2, seed=42, params=params)
    pool = (lj.lj_displacement_move(sigma=0.05, weight=0.8, params=params),
            lj.lj_swap_move(weight=0.2, params=params))
    path = _tmp("config5")
    sim = mc.Simulation(lj.make_system(params), chains, [
        dict(algorithm=mc.Metropolis, pool=pool, seed=7),
        dict(algorithm=pg.PolicyGradientEstimator,
             dependencies=(mc.Metropolis,),
             optimisers=(pg.VPG(0.02), pg.Static()), q_batch_size=1,
             scheduler=np.arange(4, steps + 1, 4)),
        dict(algorithm=pg.PolicyGradientUpdate,
             dependencies=(pg.PolicyGradientEstimator,),
             scheduler=np.arange(8, steps + 1, 8)),
        dict(algorithm=mc.StoreCallbacks,
             callbacks=(lj.callback_energy_per_particle,),
             scheduler=np.arange(100, steps + 1, 100)),
        dict(algorithm=mc.StoreParameters, dependencies=(mc.Metropolis,),
             scheduler=np.arange(8, steps + 1, 8))], steps, path=path)
    assert not sim.device_algos[0].supports_fused
    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0
    ds = sim.device_state
    cnt = np.asarray(ds["metropolis"]["counters"])
    np.testing.assert_array_equal(cnt[:, :, 1].sum(axis=1), steps)
    np.testing.assert_array_equal(np.asarray(chains.species).sum(1),
                                  np.asarray(ds["sys"].species).sum(1))
    sig = np.loadtxt(os.path.join(path, "parameters", "1", "parameters.dat"),
                     converters={1: lambda s: float(s.strip("[],"))})
    assert sig[-1, 1] > sig[0, 1] * 1.02, f"sigma {sig[0, 1]} -> {sig[-1, 1]}"

    # incremental energy cache after a stretch of the bare generic step
    # (Simulation.run refreshes the cache at every sync point); float32,
    # so rtol 1e-4 over a few hundred N=1024 updates
    bare = mc.Simulation(lj.make_system(params), ds["sys"], [
        dict(algorithm=mc.Metropolis, pool=pool, seed=8)], time_steps,
        path=_tmp("config5_bare"))
    ds0 = bare.init_device_state()
    out = _bare_advance(bare, ds0, time_steps)
    e_true = jax.vmap(lambda s: lj.total_energy(s, params))(out["sys"])
    np.testing.assert_allclose(np.asarray(out["sys"].energy),
                               np.asarray(e_true), rtol=1e-4,
                               err_msg="config-5 energy cache")
    np.testing.assert_array_equal(np.asarray(out["sys"].species).sum(1),
                                  np.asarray(chains.species).sum(1))
    adv = jax.jit(_select_advance(bare))
    masks = (jnp.ones(time_steps + 1, bool),)
    t_step = _timed(lambda: adv(ds0, masks, time_steps)) / time_steps
    return (f"N={n}, {n_chains} chains, {steps} steps with PGMC in "
            f"{wall:.2f} s (compile included); sigma {sig[0, 1]:.4f} -> "
            f"{sig[-1, 1]:.4f}; generic step {t_step * 1e6:.1f} us "
            f"(median of 5 x {time_steps} steps)")


# -- e. cell path at N=16384 -----------------------------------------------

def phase_cell(n_chains=32, n=16384, steps=20, check_chains=4):
    params = lj.LJParams()
    chains = lj.init_chains(n_chains, n, rho=1.2, beta=1.0 / 0.45,
                            frac_b=0.2, seed=42, params=params)
    pool = (lj.lj_displacement_move(0.08, params=params),)
    sim = mc.Simulation(lj.make_system(params), chains, [
        dict(algorithm=mc.Metropolis, pool=pool, seed=7, sweepstep=n // 4),
        dict(algorithm=mc.StoreCallbacks,
             callbacks=(lj.callback_energy_per_particle,),
             scheduler=np.arange(5, steps + 1, 5))], steps,
        path=_tmp("cell"))
    met = sim.device_algos[0]
    assert met._use_cell, "cell MC was not selected at N=16384"
    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0
    assert met._use_cell, "the run fell back to the generic path"
    out = _bare_advance(sim, sim.device_state, 5)
    assert not bool(np.asarray(out["metropolis"]["cell_overflow"])), \
        "cell capacity overflow"
    sub = jax.tree_util.tree_map(lambda a: a[:check_chains], out["sys"])
    e_true = np.asarray(jax.lax.map(
        lambda s: lj.total_energy(s, params, row_batch=256), sub))
    np.testing.assert_allclose(np.asarray(sub.energy), e_true, rtol=2e-4,
                               err_msg="cell-path energy cache")
    cnt = np.asarray(out["metropolis"]["counters"])
    return (f"N={n}, {n_chains} chains, {steps} x {n // 4} attempts through "
            f"Simulation.run in {wall:.2f} s (compile included); acceptance "
            f"{cnt[:, 0, 0].sum() / cnt[:, 0, 1].sum():.3f}; no overflow")


# -- f. four cards ---------------------------------------------------------

def _stack(n_chains, steps, path, mesh):
    """PGMC + recorders + checkpoint on the generic path."""
    pool = (p1d.displacement_move(sigma=0.2, weight=0.5),
            p1d.displacement_move(sigma=0.2, weight=0.5))
    stride = steps // 10
    sim = mc.Simulation(p1d.make_system(p1d.harmonic),
                        p1d.init_chains(n_chains, BETA, 42), [
        dict(algorithm=mc.Metropolis, pool=pool, seed=42),
        dict(algorithm=pg.PolicyGradientEstimator,
             dependencies=(mc.Metropolis,),
             optimisers=(pg.Static(), pg.VPG(0.001)), q_batch_size=2),
        dict(algorithm=pg.PolicyGradientUpdate,
             dependencies=(pg.PolicyGradientEstimator,),
             scheduler=np.arange(stride, steps + 1, stride)),
        dict(algorithm=mc.StoreCallbacks,
             callbacks=(p1d.callback_energy, mc.callback_acceptance),
             scheduler=np.arange(1, steps + 1)),
        dict(algorithm=mc.StoreTrajectories, fmt=mc.BIN(),
             scheduler=np.asarray([steps // 2, steps])),
        dict(algorithm=mc.StoreParameters, dependencies=(mc.Metropolis,),
             scheduler=np.asarray([steps])),
        dict(algorithm=mc.StoreBackups, scheduler=np.asarray([steps // 2]))],
        steps, path=path, mesh=mesh)
    sim.run()
    return sim


def _same_files(a, b, names):
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), f"{name} differs from one card"


def phase_four_cards(n_chains=10_000, steps=200, fused="auto"):
    from montecarlo_tpu.parallel import make_mesh
    mesh = make_mesh(n_devices=4)
    one = jax.devices()[:1]
    p4, p1 = _tmp("mesh4"), _tmp("mesh1")
    s4 = _stack(n_chains, steps, p4, mesh)
    s1 = _stack(n_chains, steps, p1, None)
    traj = sorted(os.path.relpath(os.path.join(r, f), p4)
                  for r, _, fs in os.walk(os.path.join(p4, "trajectories"))
                  for f in fs)
    # per-chain data and the PGMC-adapted sigma: bitwise (counter-based
    # per-chain streams do not depend on the sharding)
    _same_files(p4, p1, [os.path.join("parameters", "2", "parameters.dat")]
                + traj)
    # chain averages are float32 reductions whose order follows the
    # sharding: equal to rounding (rtol 1e-6)
    rel = 0.0
    for name in ("energy.dat", "acceptance.dat"):
        a, b = (np.loadtxt(os.path.join(p, name)) for p in (p4, p1))
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
        rel = max(rel, float(np.max(np.abs(a - b) / np.abs(b).clip(1e-30))))
    for k in ("x", "e"):
        np.testing.assert_array_equal(
            np.asarray(getattr(s4.device_state["sys"], k)),
            np.asarray(getattr(s1.device_state["sys"], k)))
    np.testing.assert_array_equal(
        np.asarray(s4.device_state["metropolis"]["counters"]),
        np.asarray(s1.device_state["metropolis"]["counters"]))
    c4 = mc.checkpoint.restore(
        os.path.join(p4, "checkpoints", f"ckpt_t{steps // 2}.npz"),
        s1.init_device_state())
    c1 = mc.checkpoint.restore(
        os.path.join(p1, "checkpoints", f"ckpt_t{steps // 2}.npz"),
        s1.init_device_state())
    np.testing.assert_array_equal(np.asarray(c4["sys"].x),
                                  np.asarray(c1["sys"].x))

    # sharded Triton kernel: each shard hashes its chains' global indices,
    # so it is bitwise the one-card kernel
    from montecarlo_tpu.ops.fused_sweep import (fused_gaussian_sweep,
                                                sharded_gaussian_sweep)
    k_steps = 4_000
    x0 = p1d.init_chains(n_chains, BETA, 5).x
    b = jnp.full((n_chains,), BETA, jnp.float32)
    interp = fused == "interpret"
    x4, _, a4 = sharded_gaussian_sweep(mesh, mesh.axis_names[0], x0, b, 0.5,
                                       9, 0, k_steps, potential=p1d.harmonic,
                                       interpret=interp)
    x1, _, a1 = fused_gaussian_sweep(jax.device_put(x0, one[0]), b, 0.5, 9,
                                     0, k_steps, potential=p1d.harmonic,
                                     interpret=interp)
    x4, a4, x1, a1 = map(np.asarray, (x4, a4, x1, a1))
    np.testing.assert_array_equal(x4, x1)
    np.testing.assert_array_equal(a4, a1)
    se = x4.std() / np.sqrt(2 * n_chains)
    assert abs(x4.std() - 1 / np.sqrt(2 * BETA)) < N_SE * se, x4.std()
    return (f"4-card mesh vs 1 card, {n_chains} chains x {steps} steps, "
            f"PGMC + recorders + checkpoint: bitwise equal ({len(traj)} "
            f"trajectory files, sigma, state, counters, checkpoint), chain "
            f"averages within {rel:.1e} relative; sharded Triton kernel "
            f"{k_steps} steps: bitwise "
            f"equal to one card, x std {x4.std():.4f}, acceptance "
            f"{a4.sum() / (n_chains * k_steps):.4f}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU chain-mesh phase")
    args = ap.parse_args()

    setup_compile_cache()
    device = require_gpu(4 if args.four_cards else 1)
    print(f"a. device: ok ({device['kind']} x {device['count']})")
    print(gpu_line(), flush=True)
    phases = ([("f. four cards", phase_four_cards)] if args.four_cards else
              [("b. flagship", phase_flagship),
               ("c. kernel vs reference", phase_kernel_vs_reference),
               ("d. config 5", phase_config5),
               ("e. cell path", phase_cell)])
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            msg = fn()
        except Exception:  # noqa: BLE001 - every phase reports, then exit
            traceback.print_exc()
            failed.append(name)
            print(f"{name}: FAILED", flush=True)
            continue
        print(f"{name}: ok in {time.perf_counter() - t0:.1f} s — {msg}",
              flush=True)
    if failed:
        sys.exit(f"failed phases: {', '.join(failed)}")
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
