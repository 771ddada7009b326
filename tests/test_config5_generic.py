"""BASELINE config 5's pool (Kob–Andersen LJ, displacement + swap) on the
generic path, run through ``Simulation.run``: the path this pool takes on
every backend below the cell-MC size.

Small N and few chains; ``chip_smoke.py`` runs the same checks at N=1024
with PGMC on the card.
"""

import jax
import numpy as np
import pytest

import montecarlo_tpu as mc
from montecarlo_tpu.models import lennard_jones as lj

PARAMS = lj.LJParams()
M, N, STEPS, W_DISP = 8, 32, 400, 0.8


def _run(path, frac_b, steps=STEPS):
    chains = lj.init_chains(M, N, rho=0.6, beta=1.0, frac_b=frac_b, seed=5,
                            params=PARAMS)
    pool = (lj.lj_displacement_move(0.12, weight=W_DISP, params=PARAMS),
            lj.lj_swap_move(weight=1.0 - W_DISP, params=PARAMS))
    sim = mc.Simulation(lj.make_system(PARAMS), chains,
                        [dict(algorithm=mc.Metropolis, pool=pool, seed=3)],
                        steps, path=str(path))
    assert not sim.device_algos[0].supports_fused
    sim.run()
    return chains, sim.device_state


@pytest.fixture(scope="module")
def mixed_run(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("config5"), frac_b=0.25)


def _recomputed(sys_state):
    return np.asarray(jax.vmap(lambda s: lj.total_energy(s, PARAMS))(
        sys_state))


def test_config5_cache_consistency(mixed_run):
    """Incremental energies stay consistent with an O(N^2) recompute through
    interleaved displacement and swap moves."""
    chains, ds = mixed_run
    np.testing.assert_allclose(np.asarray(ds["sys"].energy),
                               _recomputed(ds["sys"]), rtol=3e-4, atol=5e-3)
    assert not np.allclose(np.asarray(ds["sys"].pos), np.asarray(chains.pos))
    pos = np.asarray(ds["sys"].pos)
    assert pos.min() >= 0.0 and pos.max() < float(chains.box[0])


def test_config5_composition_conserved(mixed_run):
    """Swaps conserve each chain's species composition, and were accepted."""
    chains, ds = mixed_run
    np.testing.assert_array_equal(np.asarray(chains.species).sum(1),
                                  np.asarray(ds["sys"].species).sum(1))
    assert not np.array_equal(np.asarray(chains.species),
                              np.asarray(ds["sys"].species))
    cnt = np.asarray(ds["metropolis"]["counters"])
    assert cnt[:, 1, 0].sum() > 0


def test_config5_kind_fractions(mixed_run):
    """Attempts sum to the step count per chain and follow the weights."""
    _, ds = mixed_run
    cnt = np.asarray(ds["metropolis"]["counters"])
    np.testing.assert_array_equal(cnt[:, :, 1].sum(axis=1), STEPS)
    frac = cnt[:, 0, 1].sum() / cnt[:, :, 1].sum()
    assert abs(frac - W_DISP) < 0.05     # binomial se ~ 0.007
    assert np.all(cnt[..., 0] <= cnt[..., 1])


def test_config5_mono_species_pool_safe(tmp_path):
    """A chain with no B particles: a swap exchanges two identical labels,
    a no-op with dE = 0 — no phantom energy, no species corruption, cache
    still exact."""
    chains, ds = _run(tmp_path, frac_b=0.0, steps=200)
    assert np.asarray(ds["sys"].species).sum() == 0
    cnt = np.asarray(ds["metropolis"]["counters"])
    assert cnt[:, 1, 1].sum() > 0
    np.testing.assert_array_equal(cnt[:, 1, 0], cnt[:, 1, 1])
    np.testing.assert_allclose(np.asarray(ds["sys"].energy),
                               _recomputed(ds["sys"]), rtol=3e-4, atol=5e-3)
