"""Checkerboard cell-list MC (``ops/cell_mc.py``) — the large-N particle
path: bind/unbind correctness, exact incremental-energy bookkeeping, engine
integration via ``Metropolis(fused='cell')``, the random-grid-origin
pi-invariance gates, 3-D grids, NPT volume substeps, and statistical
agreement with the O(N)-row generic path (same canonical ensemble)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import montecarlo_tpu as mc
from montecarlo_tpu.models import lennard_jones as lj
from montecarlo_tpu.ops import cell_mc
from montecarlo_tpu.parallel import make_mesh

PARAMS = lj.LJParams()


def _closures():
    pe, rc2, rcut_max = lj.cell_closures(PARAMS)
    return pe, rc2, rcut_max


def test_plan_grid_geometry():
    g = cell_mc.plan_grid(1024, 29.2, rcut=2.5, d_cap=0.45)
    assert g.nc % 2 == 0 and g.nc >= 4
    assert g.w >= 2.5 + 2 * 0.45
    assert g.nc * g.nc * g.cap >= 1024
    assert g.box_min <= 29.2
    with pytest.raises(ValueError):
        cell_mc.plan_grid(64, 8.0, rcut=2.5, d_cap=0.45)  # box too small
    # quantile capacity: an observed max occupancy lifts the cap
    g2 = cell_mc.plan_grid(1024, 29.2, rcut=2.5, d_cap=0.45,
                           max_occupancy=60)
    assert g2.cap >= 62
    # 3-D plan
    g3 = cell_mc.plan_grid(4096, 16.0, rcut=2.5, d_cap=0.45, dim=3)
    assert g3.dim == 3 and g3.nc == 4


def test_bind_unbind_roundtrip():
    st = lj.init_chains(1, 512, rho=1.0, beta=1.0, frac_b=0.2, seed=2,
                        params=PARAMS)
    box = float(st.box[0])
    grid = cell_mc.plan_grid(512, box, rcut=2.5, d_cap=0.45)
    s = (st.pos[0] / box) % 1.0
    cells = cell_mc.bind_cells(grid, s, st.species[0].astype(jnp.float32))
    assert not bool(cells["overflow"])
    assert int(cells["occ"].sum()) == 512
    s2, attr = cell_mc.unbind_cells(cells, 512)
    np.testing.assert_array_equal(np.asarray(s2), np.asarray(s))
    np.testing.assert_array_equal(np.asarray(attr),
                                  np.asarray(st.species[0]))


def test_cell_total_energy_matches_dense():
    pe, rc2, _ = _closures()
    for dim, n in ((2, 512), (3, 4096)):
        st = lj.init_chains(1, n, rho=1.0, beta=1.0, frac_b=0.2, seed=3,
                            params=PARAMS, dim=dim)
        box = float(st.box[0])
        grid = cell_mc.plan_grid(n, box, rcut=2.5, d_cap=0.45, dim=dim)
        e_cell = float(cell_mc.cell_total_energy(
            grid, pe, rc2, st.pos[0], st.species[0].astype(jnp.float32),
            box))
        e_full = float(st.energy[0])
        np.testing.assert_allclose(e_cell, e_full, rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("dim,n", [(2, 512), (3, 4096)])
def test_segment_energy_bookkeeping(dim, n):
    pe, rc2, _ = _closures()
    rho = 1.2 if dim == 2 else 1.0
    st = lj.init_chains(2, n, rho=rho, beta=1.0 / 0.45, frac_b=0.2,
                        seed=4, params=PARAMS, dim=dim)
    grid = cell_mc.plan_grid(n, float(st.box[0]), rcut=2.5, d_cap=0.45,
                             dim=dim)
    pos, _, e, box_o, att, acc, ovf = cell_mc.cell_mc_segment(
        grid, pe, rc2, st.pos, st.species.astype(jnp.float32), st.beta,
        st.energy, 0.08, jax.random.key(0), 100, box=st.box)
    assert not bool(np.any(np.asarray(ovf)))
    assert np.all(np.asarray(att)[:, 0] > 0)
    assert np.all(np.asarray(acc)[:, 0] > 0)
    np.testing.assert_array_equal(np.asarray(box_o), np.asarray(st.box))
    st2 = dataclasses.replace(st, pos=pos, energy=e)
    e_true = np.asarray(jax.lax.map(
        lambda s: lj.total_energy(s, PARAMS), st2))
    np.testing.assert_allclose(np.asarray(e), e_true, rtol=2e-5, atol=5e-2)


@pytest.fixture(scope="module")
def engine_cell_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cellmc"))
    N, M, steps = 512, 8, 40
    chains = lj.init_chains(M, N, rho=1.0, beta=1.0, frac_b=0.2, seed=6,
                            params=PARAMS)
    pool = (lj.lj_displacement_move(0.1, params=PARAMS),)
    mesh = make_mesh(n_devices=8)
    sim = mc.Simulation(
        lj.make_system(PARAMS), chains,
        [dict(algorithm=mc.Metropolis, pool=pool, seed=1, sweepstep=64,
              fused="cell"),
         dict(algorithm=mc.StoreCallbacks,
              callbacks=(lj.callback_energy_per_particle,),
              scheduler=np.arange(10, steps + 1, 10))],
        steps, path=path, mesh=mesh)
    sim.run()
    return sim, path, steps


def test_engine_cell_path(engine_cell_run):
    sim, path, steps = engine_cell_run
    met = sim.device_algos[0]
    assert met._use_cell and met.supports_fused
    slc = sim.device_state["metropolis"]
    assert not bool(np.asarray(slc["cell_overflow"]))
    cnt = np.asarray(slc["counters"])
    # fractional-substep debt keeps executed attempts within one substep
    # of the requested count (ADVICE r4: no per-segment round-up)
    want = steps * 64
    per = met._cell_plan.nc ** 2 // 4
    assert np.all(cnt[:, 0, 1] >= want - per)
    assert np.all(cnt[:, 0, 1] <= want + per)
    assert np.all(cnt[:, 0, 0] > 0)
    e = np.loadtxt(f"{path}/energy_per_particle.dat")
    assert np.all(np.isfinite(e[:, 1]))


def test_engine_cell_energy_consistent(engine_cell_run):
    sim, _, _ = engine_cell_run
    st = sim.device_state["sys"]
    e_true = np.asarray(jax.lax.map(
        lambda s: lj.total_energy(s, PARAMS), st))
    # refresh hook revalidated at the last observation point
    np.testing.assert_allclose(np.asarray(st.energy), e_true, rtol=1e-5,
                               atol=1e-2)


def test_cell_vs_generic_same_ensemble_multisegment(tmp_path):
    """Equilibrium e/N from the cell path matches the generic row path —
    run as MANY short segments (a fresh random grid origin per bind), the
    regime where a fixed-origin grid would accumulate its halo-coverage
    bias (ADVICE r4 high)."""
    N, M = 256, 32
    st = lj.init_chains(M, N, rho=1.0, beta=1.0, frac_b=0.0, seed=8,
                        params=PARAMS)
    pe, rc2, _ = _closures()
    grid = cell_mc.plan_grid(N, float(st.box[0]), rcut=2.5, d_cap=0.45)
    per = grid.nc * grid.nc // 4
    n_seg, sub_per_seg = 30, 25
    pos, attr, e = st.pos, st.species.astype(jnp.float32), st.energy
    att_tot = 0
    for seg in range(n_seg):
        pos, attr, e, _, att, _, ovf = cell_mc.cell_mc_segment(
            grid, pe, rc2, pos, attr, st.beta, e, 0.12,
            jax.random.key(100 + seg), sub_per_seg, box=st.box)
        assert not bool(np.any(np.asarray(ovf)))
        att_tot += int(np.asarray(att)[:, 0].sum())
    st_c = dataclasses.replace(st, pos=pos, energy=e)
    e_cell = np.asarray(jax.lax.map(
        lambda s: lj.total_energy(s, PARAMS), st_c)) / N

    # reference: the generic row path through Simulation.run, the same
    # number of displacement attempts per chain
    n_moves = att_tot // M
    sim = mc.Simulation(
        lj.make_system(PARAMS), st,
        [dict(algorithm=mc.Metropolis, fused="off", seed=17,
              pool=(lj.lj_displacement_move(0.12, params=PARAMS),))],
        n_moves, path=str(tmp_path))
    sim.run()
    e_row = np.asarray(jax.lax.map(
        lambda s: lj.total_energy(s, PARAMS), sim.device_state["sys"])) / N

    se = np.sqrt(e_cell.std() ** 2 / M + e_row.std() ** 2 / M)
    assert abs(e_cell.mean() - e_row.mean()) < 4 * se + 0.015, (
        f"cell {e_cell.mean():.4f} vs row {e_row.mean():.4f} (se {se:.4f})")


def test_random_origin_uniformises_positions():
    """Distributional gate for the random grid origin (ADVICE r4 high): in
    a LOW-density gas sampled by many short cell segments, the marginal of
    (position mod cell width) must stay uniform.  A fixed-origin grid
    piles density into the +/- d_cap halo bands (x2 edge, x4 corner
    coverage); the per-bind uniform origin shift removes the bias."""
    N, M = 64, 64
    st = lj.init_chains(M, N, rho=0.05, beta=1.0, frac_b=0.0, seed=9,
                        params=PARAMS)
    pe, rc2, _ = _closures()
    box = float(st.box[0])
    grid = cell_mc.plan_grid(N, box, rcut=2.5, d_cap=0.45)
    pos, attr, e = st.pos, st.species.astype(jnp.float32), st.energy
    frac = []
    for seg in range(40):
        pos, attr, e, _, _, _, ovf = cell_mc.cell_mc_segment(
            grid, pe, rc2, pos, attr, st.beta, e, 0.5,
            jax.random.key(200 + seg), 40, box=st.box)
        assert not bool(np.any(np.asarray(ovf)))
        if seg >= 10:   # burn-in
            frac.append(np.asarray(pos).reshape(-1) % grid.w / grid.w)
    frac = np.concatenate(frac)
    hist, _ = np.histogram(frac, bins=8, range=(0.0, 1.0))
    expected = len(frac) / 8
    chi2 = ((hist - expected) ** 2 / expected).sum()
    # chi2_(7 dof): mean 7, sd ~3.7; 50 is a ~10-sigma alarm only a real
    # grid-commensurate bias would trip (samples are correlated, so the
    # nominal p-value does not apply — this is an order-of-magnitude gate)
    assert chi2 < 50, (chi2, hist)


def test_cell_swap_species_conserved():
    """Within-cell species swaps: composition conserved, cache exact, both
    kinds attempted."""
    pe, rc2, _ = _closures()
    st = lj.init_chains(4, 512, rho=1.2, beta=1.0 / 0.45, frac_b=0.2,
                        seed=11, params=PARAMS)
    grid = cell_mc.plan_grid(512, float(st.box[0]), rcut=2.5, d_cap=0.45)
    pos, attr, e, _, att, acc, ovf = cell_mc.cell_mc_segment(
        grid, pe, rc2, st.pos, st.species.astype(jnp.float32), st.beta,
        st.energy, 0.08, jax.random.key(1), 400, w_disp=0.6,
        swap_mode="species", box=st.box)
    assert not bool(np.any(np.asarray(ovf)))
    att = np.asarray(att)
    assert np.all(att[:, 0] > 0) and np.all(att[:, 1] > 0)
    assert np.all(np.asarray(acc)[:, 1] > 0)
    species = np.asarray(attr).astype(np.int64)
    np.testing.assert_array_equal(species.sum(axis=1),
                                  np.asarray(st.species).sum(axis=1))
    st2 = dataclasses.replace(st, pos=pos,
                              species=attr.astype(st.species.dtype),
                              energy=e)
    e_true = np.asarray(jax.lax.map(
        lambda s: lj.total_energy(s, PARAMS), st2))
    np.testing.assert_allclose(np.asarray(e), e_true, rtol=1e-4, atol=5e-2)


def test_cell_swap_pair_diameters_conserved():
    """Polydisperse within-cell pair swaps conserve the diameter multiset
    and keep the incremental energy cache exact."""
    from montecarlo_tpu.models import polydisperse as poly

    params = poly.PolyParams()
    pe, rc2, rcut_max = poly.cell_closures(params)
    st = poly.init_chains(4, 512, rho=1.0, beta=1.0, seed=12, params=params)
    grid = cell_mc.plan_grid(512, float(st.box[0]), rcut_max, d_cap=0.45)
    pos, diam, e, _, att, acc, ovf = cell_mc.cell_mc_segment(
        grid, pe, rc2, st.pos, st.diam, st.beta, st.energy, 0.08,
        jax.random.key(2), 400, w_disp=0.6, swap_mode="pair", box=st.box)
    assert not bool(np.any(np.asarray(ovf)))
    assert np.all(np.asarray(att)[:, 1] > 0)
    d_new = np.sort(np.asarray(diam), axis=1)
    d_old = np.sort(np.asarray(st.diam), axis=1)
    np.testing.assert_allclose(d_new, d_old, rtol=0, atol=0)
    st2 = dataclasses.replace(st, pos=pos, diam=diam, energy=e)
    e_true = np.asarray(jax.lax.map(
        lambda s: poly.total_energy(s, params), st2))
    np.testing.assert_allclose(np.asarray(e), e_true, rtol=1e-4, atol=5e-2)


def test_engine_cell_mixed_pool():
    """Metropolis(fused='cell') on the LJ mixed displacement+swap pool:
    per-move counters split by kind, species conserved end to end."""
    N, M, steps = 512, 4, 24
    chains = lj.init_chains(M, N, rho=1.2, beta=1.0 / 0.45, frac_b=0.2,
                            seed=13, params=PARAMS)
    pool = (lj.lj_displacement_move(0.08, weight=0.7, params=PARAMS),
            lj.lj_swap_move(weight=0.3, params=PARAMS))
    sim = mc.Simulation(
        lj.make_system(PARAMS), chains,
        [dict(algorithm=mc.Metropolis, pool=pool, seed=3, sweepstep=64,
              fused="cell")],
        steps, path="/tmp/mctpu_cell_mixed")
    met = sim.device_algos[0]
    assert met._use_cell and met.supports_fused
    sim.run()
    slc = sim.device_state["metropolis"]
    assert not bool(np.asarray(slc["cell_overflow"]))
    cnt = np.asarray(slc["counters"])
    assert np.all(cnt[:, 0, 1] > 0) and np.all(cnt[:, 1, 1] > 0)
    st = sim.device_state["sys"]
    np.testing.assert_array_equal(
        np.asarray(st.species).sum(axis=1),
        np.asarray(chains.species).sum(axis=1))
    e_true = np.asarray(jax.lax.map(
        lambda s: lj.total_energy(s, PARAMS), st))
    np.testing.assert_allclose(np.asarray(st.energy), e_true, rtol=1e-5,
                               atol=1e-2)


def test_pgmc_composes_with_cell_path():
    """Hybrid advance + cell fast path: PGMC adapts sigma while Metropolis
    runs cell-MC segments between estimator/update events."""
    from montecarlo_tpu import policy_guided as pg
    from montecarlo_tpu.core.simulation import _select_advance

    N, M, steps = 512, 4, 24
    chains = lj.init_chains(M, N, rho=1.0, beta=1.0, frac_b=0.2, seed=15,
                            params=PARAMS)
    pool = (lj.lj_displacement_move(0.05, params=PARAMS),)
    sim = mc.Simulation(
        lj.make_system(PARAMS), chains,
        [dict(algorithm=mc.Metropolis, pool=pool, seed=2, sweepstep=32,
              fused="cell"),
         dict(algorithm=pg.PolicyGradientEstimator,
              dependencies=(mc.Metropolis,), optimisers=(pg.VPG(0.02),),
              q_batch_size=1, scheduler=np.arange(4, steps + 1, 4)),
         dict(algorithm=pg.PolicyGradientUpdate,
              dependencies=(pg.PolicyGradientEstimator,),
              scheduler=np.arange(8, steps + 1, 8))],
        steps, path="/tmp/mctpu_cell_pgmc")
    advance = _select_advance(sim)
    assert "hybrid" in advance.__qualname__
    assert sim.device_algos[0]._use_cell
    sim.run()
    sigma = float(jax.tree_util.tree_leaves(
        sim.device_state["params"][0])[0])
    assert sigma > 0.05 * 1.01   # VPG grew the too-small width
    assert not bool(np.asarray(
        sim.device_state["metropolis"]["cell_overflow"]))


def test_anchor_constraint_invariant():
    """Correctness cornerstone: during a segment a particle's net per-axis
    displacement is bounded by the storage-cell halo width (it can only
    move within its shifted cell's +/- d_cap halo) — this is what makes
    simultaneous same-color moves independent and the 3^dim neighbourhood
    sufficient without re-binning."""
    pe, rc2, _ = _closures()
    st = lj.init_chains(2, 512, rho=1.0, beta=1.0, frac_b=0.2, seed=20,
                        params=PARAMS)
    box = float(st.box[0])
    grid = cell_mc.plan_grid(512, box, rcut=2.5, d_cap=0.45)
    pos1, _, _, _, _, _, _ = cell_mc.cell_mc_segment(
        grid, pe, rc2, st.pos, st.species.astype(jnp.float32), st.beta,
        st.energy, 0.3, jax.random.key(3), 500,
        box=st.box)   # big sigma stresses it
    d = np.asarray(pos1) - np.asarray(st.pos)
    d = (d + box / 2) % box - box / 2
    # both endpoints inside [cell - d_cap, cell + w + d_cap)
    bound = grid.w + 2 * grid.d_cap + 1e-5
    assert np.all(np.abs(d) <= bound), np.abs(d).max()


def test_fused_cell_unplannable_raises():
    """An explicit fused='cell' request must fail loudly when the cell
    decomposition cannot be planned (here: box too small), not silently
    degrade to the generic path."""
    st = lj.init_chains(4, 32, rho=1.0, beta=1.0, seed=30, params=PARAMS)
    pool = (lj.lj_displacement_move(0.1, params=PARAMS),)
    with pytest.raises(ValueError, match="fused='cell'"):
        mc.Simulation(
            lj.make_system(PARAMS), st,
            [dict(algorithm=mc.Metropolis, pool=pool, seed=1,
                  fused="cell")],
            4, path="/tmp/mctpu_cell_raise")


def test_invalid_bind_is_noop_and_flagged():
    """Capacity overflow / box below the validity floor: the chain's
    segment is a no-op (state unchanged, zero counters) and the invalid
    flag is set — no silent corruption."""
    pe, rc2, _ = _closures()
    st = lj.init_chains(2, 512, rho=1.2, beta=1.0 / 0.45, seed=31,
                        params=PARAMS)
    box = float(st.box[0])
    # capacity 8 << the ~32 mean occupancy: every chain's bind overflows
    bad = cell_mc.CellGrid(nc=4, cap=8, box=box, d_cap=0.45, rcut=2.5)
    pos, attr, e, _, att, acc, inv = cell_mc.cell_mc_segment(
        bad, pe, rc2, st.pos, st.species.astype(jnp.float32), st.beta,
        st.energy, 0.08, jax.random.key(0), 50, box=st.box)
    assert bool(np.all(np.asarray(inv)))
    np.testing.assert_array_equal(np.asarray(pos), np.asarray(st.pos))
    np.testing.assert_array_equal(np.asarray(e), np.asarray(st.energy))
    np.testing.assert_array_equal(np.asarray(att), 0)

    # box below the grid's validity floor: invalid, no-op
    good = cell_mc.plan_grid(512, box, rcut=2.5, d_cap=0.45)
    pos2, _, _, _, att2, _, inv2 = cell_mc.cell_mc_segment(
        good, pe, rc2, st.pos, st.species.astype(jnp.float32), st.beta,
        st.energy, 0.08, jax.random.key(0), 50,
        box=jnp.full((2,), good.box_min * 0.9, jnp.float32))
    assert bool(np.all(np.asarray(inv2)))
    np.testing.assert_array_equal(np.asarray(pos2), np.asarray(st.pos))

    # a LARGER per-chain box is fine (fractional geometry): no flag
    _, _, _, _, att3, _, inv3 = cell_mc.cell_mc_segment(
        good, pe, rc2, st.pos * 1.1, st.species.astype(jnp.float32),
        st.beta, st.energy, 0.08, jax.random.key(0), 50,
        box=jnp.full((2,), box * 1.1, jnp.float32))
    assert not bool(np.any(np.asarray(inv3)))
    assert np.all(np.asarray(att3)[:, 0] > 0)


def test_engine_surfaces_invalid_bind():
    """Simulation.run raises when an EXPLICIT fused='cell' run latched an
    invalid bind (auto-selected runs fall back instead — see
    test_auto_cell_falls_back_on_overflow)."""
    st = lj.init_chains(2, 512, rho=1.2, beta=1.0 / 0.45, seed=32,
                        params=PARAMS)
    pool = (lj.lj_displacement_move(0.08, params=PARAMS),)
    sim = mc.Simulation(
        lj.make_system(PARAMS), st,
        [dict(algorithm=mc.Metropolis, pool=pool, seed=1, sweepstep=16,
              fused="cell")],
        8, path="/tmp/mctpu_cell_invalid")
    met = sim.device_algos[0]
    # sabotage the plan with an undersized capacity to force overflow
    met._cell_plan = cell_mc.CellGrid(
        nc=met._cell_plan.nc, cap=8, box=met._cell_plan.box,
        d_cap=met._cell_plan.d_cap, rcut=met._cell_plan.rcut)
    with pytest.raises(RuntimeError, match="invalid"):
        sim.run()


def test_auto_cell_falls_back_on_overflow():
    """An AUTO-selected cell path that overflows mid-run falls back to the
    generic path with a warning and completes the run (ADVICE r4 medium:
    a routine capacity overflow must not abort the simulation)."""
    N, M, steps = 2048, 2, 8
    st = lj.init_chains(M, N, rho=1.0, beta=1.0, seed=33, params=PARAMS)
    pool = (lj.lj_displacement_move(0.08, params=PARAMS),)
    sim = mc.Simulation(
        lj.make_system(PARAMS), st,
        [dict(algorithm=mc.Metropolis, pool=pool, seed=1, sweepstep=4),
         dict(algorithm=mc.StoreCallbacks,
              callbacks=(lj.callback_energy_per_particle,),
              scheduler=np.arange(1, steps + 1))],
        steps, path="/tmp/mctpu_cell_fallback")
    met = sim.device_algos[0]
    assert met._use_cell
    met._cell_plan = cell_mc.CellGrid(
        nc=met._cell_plan.nc, cap=8, box=met._cell_plan.box,
        d_cap=met._cell_plan.d_cap, rcut=met._cell_plan.rcut)
    with pytest.warns(RuntimeWarning, match="falling back"):
        sim.run()
    assert met._cell_disabled and not met._use_cell
    # run completed on the generic path: all events recorded, moves made
    e = np.loadtxt("/tmp/mctpu_cell_fallback/energy_per_particle.dat")
    assert e.shape[0] == steps + 1          # store_first + every step
    cnt = np.asarray(sim.device_state["metropolis"]["counters"])
    assert np.all(cnt[:, 0, 1] > 0)


def test_hard_disk_cell_path():
    """Hard disks through the cell path: accept-iff-overlap-free via the
    infinite energy wall, overlap-free invariant preserved, uniform-square
    proposal matching the pool's convention."""
    from montecarlo_tpu.models import hard_disks as hd

    N, M, steps = 2048, 4, 30
    chains = hd.init_chains(M, N, eta=0.70, seed=40)
    pool = (hd.displacement_move(0.12),)
    sim = mc.Simulation(
        hd.make_system(), chains,
        [dict(algorithm=mc.Metropolis, pool=pool, seed=5, sweepstep=128,
              fused="cell"),
         dict(algorithm=mc.StoreCallbacks, callbacks=(hd.callback_psi6,),
              scheduler=np.arange(10, steps + 1, 10))],
        steps, path="/tmp/mctpu_hd_cell")
    met = sim.device_algos[0]
    assert met._use_cell and met._cell_model[2] == "hd"
    assert met._cell_model[8] == "square"
    sim.run()
    slc = sim.device_state["metropolis"]
    assert not bool(np.asarray(slc["cell_overflow"]))
    cnt = np.asarray(slc["counters"])
    rate = cnt[:, 0, 0].sum() / cnt[:, 0, 1].sum()
    assert 0.1 < rate < 0.99, rate
    ok = np.asarray(jax.vmap(hd.overlap_free)(sim.device_state["sys"]))
    assert ok.all(), "cell path produced hard-core overlaps"
    p6 = np.loadtxt("/tmp/mctpu_hd_cell/psi6.dat")
    assert np.all((p6[:, 1] >= 0) & (p6[:, 1] <= 1))


def test_auto_cell_with_volume_moves_npt():
    """NPT at cell speed: a displacement+volume pool engages the cell path
    (fractional-coordinate grid; volume substeps rescale per-chain boxes
    on the bound state) and the sampled density matches the generic-path
    NPT run at the same pressure."""
    N, M, steps = 2048, 8, 60
    P = 2.0
    chains = lj.init_chains(M, N, rho=0.65, beta=1.0, frac_b=0.0, seed=41,
                            params=PARAMS)
    pool = (lj.lj_displacement_move(0.12, weight=0.95, params=PARAMS),
            lj.lj_volume_move(dlnv=0.003, pressure=P, weight=0.05,
                              params=PARAMS))
    sim = mc.Simulation(
        lj.make_system(PARAMS), chains,
        [dict(algorithm=mc.Metropolis, pool=pool, seed=1, sweepstep=512),
         dict(algorithm=mc.StoreCallbacks,
              callbacks=(lj.callback_density,),
              scheduler=np.arange(5, steps + 1, 5))],
        steps, path="/tmp/mctpu_cell_npt")
    met = sim.device_algos[0]
    assert met._use_cell, met._cell_plan_error
    assert met._cell_model[6] == 1           # vol_idx mapped
    sim.run()
    slc = sim.device_state["metropolis"]
    assert not bool(np.asarray(slc["cell_overflow"]))
    cnt = np.asarray(slc["counters"])
    assert np.all(cnt[:, 1, 1] > 0), "no volume attempts"
    assert cnt[:, 1, 0].sum() > 0, "no volume acceptances"
    st = sim.device_state["sys"]
    # boxes moved off the initial value and stayed in the valid range
    box = np.asarray(st.box)
    assert np.all(box >= met._cell_plan.box_min)
    assert np.ptp(box) > 0 or abs(box[0] - float(chains.box[0])) > 1e-6
    # energy cache stays exact through volume rescales
    e_true = np.asarray(jax.lax.map(
        lambda s: lj.total_energy(s, PARAMS), st))
    np.testing.assert_allclose(np.asarray(st.energy), e_true, rtol=1e-4,
                               atol=0.5)


def test_hard_spheres_3d_cell_path():
    """3-D hard spheres (the melting/crystallization workload) through the
    dimension-generic cell path: overlap-free invariant preserved, sane
    acceptance, infinite-wall hard core in 27-neighbourhood geometry."""
    from montecarlo_tpu.models import hard_disks as hd

    N, M, steps = 4096, 2, 10
    chains = hd.init_chains(M, N, eta=0.45, seed=50, dim=3)
    pool = (hd.displacement_move(0.1),)
    sim = mc.Simulation(
        hd.make_system(), chains,
        [dict(algorithm=mc.Metropolis, pool=pool, seed=5, sweepstep=256,
              fused="cell")],
        steps, path="/tmp/mctpu_hs3d_cell")
    met = sim.device_algos[0]
    assert met._use_cell and met._cell_plan.dim == 3
    sim.run()
    slc = sim.device_state["metropolis"]
    assert not bool(np.asarray(slc["cell_overflow"]))
    cnt = np.asarray(slc["counters"])
    rate = cnt[:, 0, 0].sum() / cnt[:, 0, 1].sum()
    assert 0.1 < rate < 0.999, rate
    ok = np.asarray(jax.vmap(hd.overlap_free)(sim.device_state["sys"]))
    assert ok.all(), "3-D cell path produced hard-core overlaps"


def test_npt_cell_matches_generic_density():
    """Direct ensemble cross-check of the VOLUME SUBSTEP: the cell path's
    NPT equilibrium density must match the generic path's at the same
    (T, P) — the two volume implementations share no code (full cell-grid
    energy pass + fractional rescale vs O(N^2) recompute + coordinate
    rescale)."""
    N, M, P = 512, 16, 2.0
    means = {}
    # equal TOTAL attempt counts per chain (~31k): the cell path batches
    # them as 60 segments of 512, the generic path as 480 steps of 64
    for mode, sweep, steps in (("cell", 512, 60), ("off", 64, 480)):
        chains = lj.init_chains(M, N, rho=0.65, beta=1.0, frac_b=0.0,
                                seed=45, params=PARAMS)
        pool = (lj.lj_displacement_move(0.12, weight=0.95, params=PARAMS),
                lj.lj_volume_move(dlnv=0.01, pressure=P, weight=0.05,
                                  params=PARAMS))
        sim = mc.Simulation(
            lj.make_system(PARAMS), chains,
            [dict(algorithm=mc.Metropolis, pool=pool, seed=1,
                  sweepstep=sweep, fused=mode)],
            steps, path=f"/tmp/mctpu_npt_xcheck_{mode}")
        if mode == "cell":
            assert sim.device_algos[0]._use_cell
        sim.run()
        rho = N / np.asarray(sim.device_state["sys"].box) ** 2
        means[mode] = (float(rho.mean()),
                       float(rho.std(ddof=1) / np.sqrt(M)))
    se = np.hypot(means["cell"][1], means["off"][1])
    assert abs(means["cell"][0] - means["off"][0]) < 4 * se + 0.01, means
