"""Interpret-mode tests for the Triton Gaussian sweep kernel, its wrapper and
the choice of stepper.

The kernel (``ops/fused_sweep.py``) is the flagship's fast path on a GPU;
these tests run it in Pallas interpret mode on the CPU, so a semantic
regression in proposal generation, acceptance, counter or cached-energy
bookkeeping turns CI red.  ``chip_smoke.py`` runs the same kernel compiled
for the card.

Reference analogue: the file-driven statistical gate of
``test/distribution_test.jl:31-37``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import montecarlo_tpu as mc
from montecarlo_tpu.core.simulation import _select_advance
from montecarlo_tpu.models import lennard_jones as lj
from montecarlo_tpu.models import particle1d as p1d
from montecarlo_tpu.models import polydisperse as poly
from montecarlo_tpu.ops.fused_sweep import (fused_gaussian_sweep, grid_for,
                                            hash_bits, sharded_gaussian_sweep)

M = 4096
BETA = 2.0
SIGMA = 0.5


def _run_gauss(x, n_steps, t0=0, seed=7, **kw):
    b = jnp.full((x.shape[0],), BETA, jnp.float32)
    return fused_gaussian_sweep(x, b, SIGMA, seed, t0, n_steps,
                                potential=p1d.harmonic, interpret=True, **kw)


def test_software_bits_are_uniformish():
    idx = jnp.arange(64 * 128, dtype=jnp.int32)
    bits = hash_bits(jnp.int32(1234), 0, idx)
    u = np.asarray(bits).astype(np.float64) / 2 ** 32
    assert abs(u.mean() - 0.5) < 5e-3
    assert abs(u.var() - 1 / 12) < 2e-3
    # different draw indices give decorrelated planes
    b2 = np.asarray(hash_bits(jnp.int32(1234), 1, idx))
    assert not np.array_equal(np.asarray(bits), b2)
    c = np.corrcoef(np.asarray(bits).ravel().astype(np.float64),
                    b2.ravel().astype(np.float64))[0, 1]
    assert abs(c) < 0.02


def test_gaussian_kernel_moments():
    """Sampled moments match the analytic harmonic target
    (mean 0, std 1/sqrt(2 beta)) — chains are independent, so the M final
    positions are M independent draws once equilibrated."""
    x1, e1, acc = _run_gauss(jnp.zeros((M,), jnp.float32), 600)
    xs = np.asarray(x1)
    tgt = 1.0 / np.sqrt(2.0 * BETA)
    assert abs(xs.mean()) < 0.03
    assert abs(xs.std() - tgt) < 0.02
    np.testing.assert_allclose(np.asarray(e1), xs ** 2, rtol=1e-5)


def test_gaussian_kernel_acceptance_matches_generic_path():
    """Same physics, different RNG stream: the acceptance rate of the fused
    kernel must agree with the production threefry engine path."""
    steps = 400
    x1, _, acc = _run_gauss(jnp.zeros((M,), jnp.float32), steps)
    acc_fused = float(np.asarray(acc).sum()) / (M * steps)

    chains = p1d.init_chains(M, beta=BETA, seed=1)
    sim = mc.Simulation(
        p1d.make_system(), chains,
        [dict(algorithm=mc.Metropolis,
              pool=(p1d.displacement_move(SIGMA),), seed=1)],
        steps, path="/tmp/mctpu_test_fused")
    from montecarlo_tpu.core.simulation import _make_advance
    ds = sim.init_device_state()
    adv = jax.jit(_make_advance(sim.device_algos))
    out = adv(ds, (jnp.ones(steps + 1, bool),), steps)
    cnt = np.asarray(out["metropolis"]["counters"])
    acc_generic = cnt[..., 0].sum() / cnt[..., 1].sum()
    assert abs(acc_fused - acc_generic) < 7e-3


def test_gaussian_kernel_segmentation_invariance():
    """Per-step absolute-time seeding: one call of N steps is bitwise equal
    to any slicing into segments (recorder schedules must not change the
    trajectory)."""
    x0 = jnp.zeros((M,), jnp.float32)
    xa, ea, acca = _run_gauss(x0, 1200)
    # ODD segment boundaries (301, 800) exercise the mid-pair masking of
    # the paired Box-Muller double-step (a segment starting or ending
    # mid-pair must mask exactly one half)
    for splits in ((300, 500, 400), (301, 499, 400), (301, 500, 399)):
        xb, accb = x0, jnp.zeros((M,), jnp.int32)
        t0 = 0
        for n in splits:
            xb, eb, a = _run_gauss(xb, n, t0=t0)
            accb = accb + a
            t0 += n
        assert np.array_equal(np.asarray(xa), np.asarray(xb)), splits
        assert np.array_equal(np.asarray(acca), np.asarray(accb)), splits


def test_gaussian_kernel_counter_semantics():
    """Accepted counts are bounded by attempts and consistent with movement:
    a chain whose position changed must have accepted at least once."""
    steps = 50
    x0 = jnp.linspace(-1.0, 1.0, M).astype(jnp.float32)
    x1, _, acc = _run_gauss(x0, steps)
    acc = np.asarray(acc)
    assert acc.min() >= 0 and acc.max() <= steps
    moved = np.asarray(x1) != np.asarray(x0)
    assert np.all(moved == (acc > 0))


def test_sharded_gaussian_sweep_runs_on_mesh():
    """Each shard hashes its chains' GLOBAL indices, so the sharded sweep
    is bitwise the single-device sweep."""
    from montecarlo_tpu.parallel import make_mesh
    mesh = make_mesh()
    n_dev = mesh.devices.size
    m = 256 * n_dev
    x = jnp.zeros((m,), jnp.float32)
    b = jnp.full((m,), BETA, jnp.float32)
    x1, e1, acc = sharded_gaussian_sweep(
        mesh, "chains", x, b, SIGMA, 7, 0, 400,
        potential=p1d.harmonic, interpret=True)
    xs = np.asarray(x1)
    assert abs(xs.std() - 0.5) < 0.05
    # chains draw independent streams: shard blocks must differ
    blocks = xs.reshape(n_dev, -1)
    assert not np.allclose(blocks[0], blocks[1])
    x_ref, _, acc_ref = _run_gauss(x, 400)
    np.testing.assert_array_equal(xs, np.asarray(x_ref))
    np.testing.assert_array_equal(np.asarray(acc), np.asarray(acc_ref))


# ---------------------------------------------------------------------------
# Wrapper: padding to the block and the 1-D grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [32, 256])
@pytest.mark.parametrize("m", [1, 127, 1000, 4097, 10_000])
def test_wrapper_padding_and_grid(m, block):
    """The chain axis is padded to a whole number of blocks, one program per
    block, and the padding never leaks into the result: outputs have the
    input's length and equal the default block's (the hash is keyed by the
    global chain index, not by the block)."""
    m_pad, n_blocks = grid_for(m, block)
    assert m_pad == n_blocks * block and m_pad >= m > m_pad - block
    x0 = jnp.linspace(-1.0, 1.0, m).astype(jnp.float32)
    x1, e1, acc = _run_gauss(x0, 5, block=block)
    assert x1.shape == e1.shape == acc.shape == (m,)
    assert np.all(np.isfinite(np.asarray(x1)))
    x_def, _, acc_def = _run_gauss(x0, 5)
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x_def))
    np.testing.assert_array_equal(np.asarray(acc), np.asarray(acc_def))


def test_grid_rejects_non_power_of_two_block():
    with pytest.raises(ValueError, match="power of two"):
        grid_for(100, 48)


# ---------------------------------------------------------------------------
# Choice of stepper: backend x fused option x pool
# ---------------------------------------------------------------------------

def _p1d_sim(fused):
    return mc.Simulation(
        p1d.make_system(), p1d.init_chains(16, beta=2.0, seed=0),
        [dict(algorithm=mc.Metropolis,
              pool=(p1d.displacement_move(sigma=0.5),), seed=1,
              fused=fused)], 4, path="/tmp/mctpu_choice_p1d")


def _lj_sim(fused, mixed):
    p = lj.LJParams()
    st = lj.init_chains(2, 32, rho=0.6, beta=1.0, frac_b=0.25, seed=5,
                        params=p)
    pool = (lj.lj_displacement_move(0.1, weight=0.8, params=p),)
    if mixed:
        pool += (lj.lj_swap_move(weight=0.2, params=p),)
    return mc.Simulation(
        lj.make_system(p), st,
        [dict(algorithm=mc.Metropolis, pool=pool, seed=1, fused=fused)],
        4, path="/tmp/mctpu_choice_lj")


def _poly_sim(fused):
    p = poly.PolyParams()
    st = poly.init_chains(2, 32, rho=0.9, beta=1.0, seed=5, params=p)
    pool = (poly.displacement_move(0.1, weight=0.7, params=p),
            poly.swap_move(weight=0.3, params=p))
    return mc.Simulation(
        poly.make_system(p), st,
        [dict(algorithm=mc.Metropolis, pool=pool, seed=1, fused=fused)],
        4, path="/tmp/mctpu_choice_poly")


@pytest.mark.parametrize("backend,fused,build,kernel", [
    ("gpu", "auto", lambda f: _p1d_sim(f), True),
    ("cpu", "auto", lambda f: _p1d_sim(f), False),
    ("gpu", "off", lambda f: _p1d_sim(f), False),
    ("cpu", "interpret", lambda f: _p1d_sim(f), True),
    ("gpu", "auto", lambda f: _lj_sim(f, mixed=True), False),
    ("gpu", "auto", lambda f: _lj_sim(f, mixed=False), False),
    ("gpu", "interpret", lambda f: _poly_sim(f), False),
], ids=["gpu-auto-p1d", "cpu-auto-p1d", "gpu-off-p1d", "cpu-interpret-p1d",
        "gpu-auto-lj-mixed", "gpu-auto-lj-disp", "gpu-interpret-poly"])
def test_kernel_choice_by_backend(monkeypatch, backend, fused, build,
                                  kernel):
    """A GPU backend gets the Triton kernel for the 1-D Gaussian pool, the
    CPU the generic path; ``fused='off'`` always opts out and
    ``'interpret'`` forces the kernel; LJ/poly pools at small N are always
    generic."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    sim = build(fused)
    assert sim.device_algos[0].supports_fused is kernel
    advance = _select_advance(sim)
    if kernel:
        assert "_select_advance" in advance.__qualname__
    else:
        assert "_make_advance" in advance.__qualname__
