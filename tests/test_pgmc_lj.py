"""BASELINE config 5 end-to-end: LJ N=1024 mixed pool + PGMC, sharded.

The flagship adaptive workload — Kob-Andersen LJ with a mixed
displacement + swap pool, PGMC adapting the displacement sigma — running on
the generic mask-scheduled stepper over the CPU mesh, with the estimator and
update as peer algorithms (ref composition: ``src/PolicyGuided/update.jl:50``,
``src/simulation.jl:185-191``).
"""

import numpy as np
import jax
import pytest

import montecarlo_tpu as mc
from montecarlo_tpu import policy_guided as pg
from montecarlo_tpu.core.simulation import _select_advance
from montecarlo_tpu.models import lennard_jones as lj
from montecarlo_tpu.models import particle1d as p1d
from montecarlo_tpu.parallel import make_mesh


@pytest.fixture(scope="module")
def lj_pgmc_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lj_pgmc"))
    N, M, steps = 1024, 8, 40
    params = lj.LJParams()
    system = lj.make_system(params)
    chains = lj.init_chains(M, N, rho=1.2, beta=1.0 / 0.45, frac_b=0.2,
                            seed=42, params=params)
    pool = (lj.lj_displacement_move(sigma=0.05, weight=0.8, params=params),
            lj.lj_swap_move(weight=0.2, params=params))
    mesh = make_mesh(n_devices=8)
    algos = [
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
             scheduler=np.arange(10, steps + 1, 10)),
        dict(algorithm=mc.StoreParameters, dependencies=(mc.Metropolis,),
             scheduler=np.arange(8, steps + 1, 8)),
    ]
    sim = mc.Simulation(system, chains, algos, steps, path=path, mesh=mesh)
    advance = _select_advance(sim)
    sim.run()
    return sim, advance, params, path, steps


def test_hybrid_advance_selected(lj_pgmc_run):
    """The LJ mixed pool has no sweep kernel: the generic stepper runs it."""
    _, advance, _, _, _ = lj_pgmc_run
    assert "_make_advance" in advance.__qualname__


def test_sigma_adapts_upward(lj_pgmc_run):
    sim, _, _, path, steps = lj_pgmc_run
    rows = [(int(t), float(v.strip("[],")))
            for t, v in (line.split()
                         for line in open(
                             f"{path}/parameters/1/parameters.dat"))]
    assert len(rows) == steps // 8 + 1
    sigma0, sigma_end = rows[0][1], rows[-1][1]
    assert sigma0 == pytest.approx(0.05)
    # VPG with reward delta^2 grows sigma from a too-small start
    assert sigma_end > sigma0 * 1.02
    # the updated sigma is what the sampler consumed (device params)
    sigma_dev = float(jax.tree_util.tree_leaves(
        sim.device_state["params"][0])[0])
    assert sigma_dev == pytest.approx(sigma_end, rel=1e-6)


def test_energy_cache_consistent(lj_pgmc_run):
    sim, _, params, _, _ = lj_pgmc_run
    sys_state = sim.device_state["sys"]
    e_cached = np.asarray(sys_state.energy)
    e_true = np.asarray(
        jax.vmap(lambda s: lj.total_energy(s, params))(sys_state))
    np.testing.assert_allclose(e_cached, e_true, rtol=1e-5)


def test_counters_and_recorders(lj_pgmc_run):
    sim, _, _, path, steps = lj_pgmc_run
    cnt = np.asarray(sim.device_state["metropolis"]["counters"])
    # every chain attempted exactly `steps` moves, split between the pool
    np.testing.assert_array_equal(cnt[:, :, 1].sum(axis=1), steps)
    assert cnt[:, 0, 1].min() > 0 and cnt[:, 1, 1].min() > 0
    e = np.loadtxt(f"{path}/energy_per_particle.dat")
    assert e.shape[0] == steps // 10 + 1   # store_first + 4 scheduled
    assert np.all(np.isfinite(e))


def test_rng_impl_fused_warning():
    system = p1d.make_system(p1d.harmonic)
    chains = p1d.init_chains(16, beta=2.0, seed=0)
    pool = (p1d.displacement_move(sigma=0.5),)
    sim = mc.Simulation(
        system, chains,
        [dict(algorithm=mc.Metropolis, pool=pool, seed=1,
              rng_impl="rbg", fused="interpret")],
        4, path="/tmp/mctpu_rngwarn")
    with pytest.warns(UserWarning, match="fused.*counter stream"):
        _select_advance(sim)


def test_fused_off_keeps_generic_path():
    system = p1d.make_system(p1d.harmonic)
    chains = p1d.init_chains(16, beta=2.0, seed=0)
    pool = (p1d.displacement_move(sigma=0.5),)
    sim = mc.Simulation(
        system, chains,
        [dict(algorithm=mc.Metropolis, pool=pool, seed=1, fused="off")],
        4, path="/tmp/mctpu_fusedoff")
    advance = _select_advance(sim)
    assert "hybrid" not in advance.__qualname__
    assert "_make_advance" in advance.__qualname__
