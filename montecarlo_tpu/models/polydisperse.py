"""Continuously polydisperse soft spheres — swap Monte Carlo for glasses.

The reference organisation's particle companion (README.md:26-31 →
TheDisorderedOrganization/ParticlesMC) targets glass-forming liquids, where
the modern workhorse is **swap MC on continuously polydisperse mixtures**
(Ninarello, Berthier & Coslovich 2017): exchanging particle *diameters*
equilibrates deeply supercooled states orders of magnitude faster than
displacement dynamics alone.  This module ships that model family:

- inverse-power-law pair potential ``u = (sigma_ij/r)^12 + smoothing`` with
  the standard non-additive cross diameter
  ``sigma_ij = (d_i + d_j)/2 * (1 - eps |d_i - d_j|)`` (eps = 0.2) and a
  C2-smooth cutoff at ``r = x_c sigma_ij`` (polynomial tail with u, u', u''
  all zero at the cut — coefficients solved exactly at import);
- power-law diameter distribution ``P(d) ~ d^-3`` on [0.73, 1.62] (the
  established continuous-polydispersity protocol), sampled by inverse CDF;
- :func:`displacement_move` (O(N) incremental dE, same vectorised pattern as
  ``lennard_jones``) and :func:`swap_move` — exchange the diameters of a
  uniformly-chosen particle pair (self-inverse, logq cancels).

Both moves run through the generic engine; since displacement-only and
displacement+swap sample the SAME canonical ensemble, their equilibrium
observables must agree — which is exactly the statistical gate in
``tests/test_polydisperse.py``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.moves import Move, MoveDef, Policy
from ..core.system import SystemDef

#: event-chain projections run in full float32, never TF32
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = [
    "PolyState",
    "PolyParams",
    "make_system",
    "init_chains",
    "sample_diameters",
    "displacement_move",
    "swap_move",
    "volume_move",
    "total_energy",
    "callback_energy_per_particle",
    "callback_density",
    "ecmc_model",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PolyState:
    """Single-chain state."""
    pos: jax.Array    # (N, dim) positions in [0, L)
    diam: jax.Array   # (N,) particle diameters
    beta: jax.Array   # () inverse temperature
    energy: jax.Array # () cached total potential energy
    box: jax.Array    # () box edge L


def _smoothing_coeffs(xc: float):
    """(c0, c2, c4) with u(xc)=u'(xc)=u''(xc)=0 for u = x^-12 + c0 + c2 x^2
    + c4 x^4 (x = r/sigma_ij)."""
    a = np.array([
        [1.0, xc ** 2, xc ** 4],
        [0.0, 2 * xc, 4 * xc ** 3],
        [0.0, 2.0, 12 * xc ** 2],
    ])
    b = np.array([-xc ** -12, 12 * xc ** -13, -156 * xc ** -14])
    c0, c2, c4 = np.linalg.solve(a, b)
    return float(c0), float(c2), float(c4)


@dataclasses.dataclass(frozen=True)
class PolyParams:
    """Static model constants (Ninarello-Berthier-Coslovich values)."""
    eps: float = 0.2          # cross-diameter non-additivity
    xc: float = 1.25          # cutoff in units of sigma_ij
    d_min: float = 0.73       # diameter distribution support
    d_max: float = 1.62

    def coeffs(self):
        return _smoothing_coeffs(self.xc)


def _pair_energy(r2, sig, params: PolyParams, c0, c2, c4):
    """Smoothed IPL-12 on squared distances (vectorized)."""
    sig2 = sig * sig
    x2 = r2 / jnp.maximum(sig2, 1e-12)
    inv2 = 1.0 / jnp.maximum(x2, 1e-12)
    inv12 = inv2 * inv2 * inv2
    inv12 = inv12 * inv12
    u = inv12 + c0 + c2 * x2 + c4 * x2 * x2
    return jnp.where(x2 < params.xc ** 2, u, 0.0)


def _sigma_ij(d_i, d_j, eps):
    return 0.5 * (d_i + d_j) * (1.0 - eps * jnp.abs(d_i - d_j))


def _min_image_r2(pos, x, box):
    d = pos - x
    d = d - box * jnp.round(d / box)
    return jnp.sum(d * d, axis=-1)


def _row_energy(state: PolyState, x, d_i, mask, params: PolyParams,
                coeffs):
    """Energy of a (virtual) particle at ``x`` with diameter ``d_i`` against
    all rows (``mask`` True rows excluded)."""
    r2 = _min_image_r2(state.pos, x, state.box)
    sig = _sigma_ij(d_i, state.diam, params.eps)
    u = _pair_energy(r2, sig, params, *coeffs)
    return jnp.sum(jnp.where(mask, 0.0, u))


def total_energy(state: PolyState, params: PolyParams = PolyParams(),
                 row_batch: int = None):
    """Full O(N^2) energy; ``row_batch`` bounds peak memory to
    ``row_batch x N`` pair terms (see ``lennard_jones.total_energy``)."""
    coeffs = params.coeffs()
    n = state.pos.shape[0]
    if row_batch is None or row_batch >= n:
        d = state.pos[:, None, :] - state.pos[None, :, :]
        d = d - state.box * jnp.round(d / state.box)
        r2 = jnp.sum(d * d, axis=-1)
        sig = _sigma_ij(state.diam[:, None], state.diam[None, :], params.eps)
        u = _pair_energy(r2, sig, params, *coeffs)
        mask = ~jnp.eye(n, dtype=bool)
        return 0.5 * jnp.sum(jnp.where(mask, u, 0.0))

    idx = jnp.arange(n)

    def row_e(i):
        return _row_energy(state, state.pos[i], state.diam[i], idx == i,
                           params, coeffs)

    return 0.5 * jnp.sum(jax.lax.map(row_e, idx, batch_size=row_batch))


def make_system(params: PolyParams = PolyParams()) -> SystemDef:
    def log_target(state: PolyState):
        return -state.beta * state.energy

    def frame(state: PolyState):
        return {"pos": state.pos, "diam": state.diam,
                "energy": state.energy}

    def format_frame(t, fr):
        n, d = fr["pos"].shape
        lines = [f"{t} {n} {float(fr['energy'])!r}"]
        for k in range(n):
            coords = " ".join(repr(float(fr["pos"][k, a]))
                              for a in range(d))
            lines.append(f"{float(fr['diam'][k])!r} {coords}")
        return "\n".join(lines)

    def refresh(state: PolyState):
        # revalidate the incremental-ΔE energy cache (float drift bound);
        # row-batched so the engine's vmap over chains stays within HBM
        n = state.pos.shape[0]
        rb = None if n <= 256 else 64
        return dataclasses.replace(
            state, energy=total_energy(state, params, row_batch=rb))

    return SystemDef(name="PolydisperseSoftSpheres2D",
                     log_target=log_target, frame=frame,
                     format_frame=format_frame, refresh=refresh)


def sample_diameters(n: int, params: PolyParams = PolyParams(),
                     seed: int = 0) -> np.ndarray:
    """P(d) ~ d^-3 on [d_min, d_max] by inverse CDF (numpy, host-side)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=n)
    a, b = params.d_min, params.d_max
    # CDF(d) = (a^-2 - d^-2) / (a^-2 - b^-2)
    inv2 = a ** -2 - u * (a ** -2 - b ** -2)
    return (inv2 ** -0.5).astype(np.float32)


def init_chains(n_chains: int, n_particles: int, rho: float, beta: float,
                seed: int = 42, params: PolyParams = PolyParams(),
                dim: int = 2) -> PolyState:
    """Square/cubic-lattice start; every chain gets the same diameter draw
    (the composition is quenched disorder shared across chains).  ``dim=3``
    gives the 3-D polydisperse glass former — every move (displacement,
    swap, volume), the cell path, and the IPL event chain are
    dimension-generic."""
    box = float((n_particles / rho) ** (1.0 / dim))
    side = int(np.ceil(n_particles ** (1.0 / dim)))
    spacing = box / side
    axes = [np.arange(side)] * dim
    grid = np.stack(np.meshgrid(*axes), axis=-1).reshape(-1, dim)
    grid = grid[:n_particles]
    base = (grid + 0.5) * spacing
    diam = sample_diameters(n_particles, params, seed=seed + 1)

    key = jax.random.key(seed)
    jitter = (0.1 * spacing) * jax.random.uniform(
        key, (n_chains, n_particles, dim), minval=-1.0, maxval=1.0)
    pos = (jnp.asarray(base, jnp.float32)[None] + jitter) % box

    state = PolyState(
        pos=pos,
        diam=jnp.broadcast_to(jnp.asarray(diam), (n_chains, n_particles)),
        beta=jnp.full((n_chains,), beta, jnp.float32),
        energy=jnp.zeros((n_chains,), jnp.float32),
        box=jnp.full((n_chains,), box, jnp.float32),
    )
    # chain-batched map (a full vmap OOMs at large M x N — see lennard_jones)
    rb = None if n_particles <= 1024 else 256
    per_chain = (rb or n_particles) * n_particles
    batch = max(1, min(n_chains, int(2 ** 27 // per_chain)))
    energy = jax.lax.map(
        lambda s: total_energy(s, params, row_batch=rb), state,
        batch_size=batch)
    return dataclasses.replace(state, energy=energy)


# ---------------------------------------------------------------------------
# Moves
# ---------------------------------------------------------------------------

class GaussianDisplacement2D(Policy):
    """Uniform particle pick + isotropic Gaussian displacement (symmetric
    in the ratio — both directions still evaluated by the generic kernel)."""

    def sample(self, params, key, state):
        ki, kd = jax.random.split(key)
        n, d = state.pos.shape
        i = jax.random.randint(ki, (), 0, n)
        delta = params["sigma"] * jax.random.normal(kd, (d,))
        return {"i": i, "delta": delta}

    def log_density(self, params, action, state):
        sigma = params["sigma"]
        d2 = jnp.sum(action["delta"] ** 2)
        n, d = state.pos.shape
        return (-d2 / (2.0 * sigma * sigma)
                - (d / 2.0) * jnp.log(2.0 * jnp.pi * sigma * sigma)
                - jnp.log(jnp.asarray(float(n), sigma.dtype)))


def displacement_move(sigma: float, weight: float = 1.0,
                      params: PolyParams = PolyParams()) -> Move:
    coeffs = params.coeffs()

    def apply(state: PolyState, action):
        i, delta = action["i"], action["delta"]
        n = state.pos.shape[0]
        mask = jnp.arange(n) == i
        old = jnp.sum(jnp.where(mask[:, None], state.pos, 0.0), axis=0)
        d_i = jnp.sum(jnp.where(mask, state.diam, 0.0))
        new = old + delta
        e_old = _row_energy(state, old, d_i, mask, params, coeffs)
        e_new = _row_energy(state, new, d_i, mask, params, coeffs)
        d_e = e_new - e_old
        pos = jnp.where(mask[:, None], new % state.box, state.pos)
        new_state = dataclasses.replace(
            state, pos=pos, energy=state.energy + d_e)
        return new_state, -state.beta * d_e

    def invert(action, new_state):
        return {"i": action["i"], "delta": -action["delta"]}

    def reward(action, new_state):
        return jnp.sum(action["delta"] ** 2)

    md = MoveDef(name="PolyDisplacement", policy=GaussianDisplacement2D(),
                 apply=apply, invert=invert, reward=reward,
                 kind="poly_displacement_2d", aux=params)
    return Move(move=md, params={"sigma": jnp.asarray(sigma, jnp.float32)},
                weight=weight)


class UniformPair(Policy):
    """Uniform unordered particle pair; self-inverse swap proposal."""

    def sample(self, params, key, state):
        ki, kj = jax.random.split(key)
        n = state.pos.shape[0]
        i = jax.random.randint(ki, (), 0, n)
        # j uniform over the other n-1 indices
        j = jax.random.randint(kj, (), 0, n - 1)
        j = jnp.where(j >= i, j + 1, j)
        return {"i": i, "j": j}

    def log_density(self, params, action, state):
        n = state.pos.shape[0]
        return -jnp.log(jnp.asarray(float(n * (n - 1)), jnp.float32))


def swap_move(weight: float = 1.0,
              params: PolyParams = PolyParams()) -> Move:
    """Exchange the diameters of particles (i, j) — the glass-equilibration
    accelerator.  dE is two O(N) row updates; the i-j pair term is invariant
    (sigma_ij symmetric in the exchange) and cancels."""
    coeffs = params.coeffs()

    def apply(state: PolyState, action):
        i, j = action["i"], action["j"]
        n = state.pos.shape[0]
        idx = jnp.arange(n)
        mask_i, mask_j = idx == i, idx == j
        mask_ij = mask_i | mask_j
        gather_d = lambda m: jnp.sum(jnp.where(m, state.diam, 0.0))
        gather_x = lambda m: jnp.sum(
            jnp.where(m[:, None], state.pos, 0.0), axis=0)
        d_i, d_j = gather_d(mask_i), gather_d(mask_j)
        x_i, x_j = gather_x(mask_i), gather_x(mask_j)
        e_old = (_row_energy(state, x_i, d_i, mask_ij, params, coeffs)
                 + _row_energy(state, x_j, d_j, mask_ij, params, coeffs))
        e_new = (_row_energy(state, x_i, d_j, mask_ij, params, coeffs)
                 + _row_energy(state, x_j, d_i, mask_ij, params, coeffs))
        d_e = e_new - e_old
        diam = jnp.where(mask_i, d_j, jnp.where(mask_j, d_i, state.diam))
        new_state = dataclasses.replace(
            state, diam=diam, energy=state.energy + d_e)
        return new_state, -state.beta * d_e

    def invert(action, new_state):
        return action  # self-inverse

    def reward(action, new_state):
        return jnp.asarray(1.0, jnp.float32)

    md = MoveDef(name="PolySwap", policy=UniformPair(),
                 apply=apply, invert=invert, reward=reward,
                 kind="poly_swap", aux=params)
    return Move(move=md, params={"dummy": jnp.zeros(())}, weight=weight)


def volume_move(dlnv: float, pressure: float, weight: float = 1.0,
                params: PolyParams = PolyParams()) -> Move:
    """Isotropic ln-V volume move — NPT swap-MC, the literature protocol for
    polydisperse glass formers (constant-pressure variant of
    Ninarello-Berthier-Coslovich).  Same acceptance as the LJ volume move
    (``lennard_jones.lj_volume_move``): the box edge scales by
    ``exp(delta/2)`` (2-D) with the full energy recomputed, and

        dlog pi = -beta (dE + P dV) + (N + 1) delta.
    """
    from .lennard_jones import UniformLogVolume

    def apply(state: PolyState, delta):
        n, d = state.pos.shape
        scale = jnp.exp(delta / d)
        box_new = state.box * scale
        pos_new = state.pos * scale
        new_state0 = dataclasses.replace(state, pos=pos_new, box=box_new)
        e_new = total_energy(new_state0, params)
        d_e = e_new - state.energy
        v_old = state.box ** d
        d_v = v_old * (jnp.exp(delta) - 1.0)
        dlogp = (-state.beta * (d_e + pressure * d_v) + (n + 1) * delta)
        return dataclasses.replace(new_state0, energy=e_new), dlogp

    def invert(delta, new_state):
        return -delta

    def reward(delta, new_state):
        return delta * delta

    # aux carries (interaction table, pressure) for the cell-MC planner
    md = MoveDef(name="PolyVolume", policy=UniformLogVolume(),
                 apply=apply, invert=invert, reward=reward,
                 kind="poly_volume", aux=(params, float(pressure)))
    return Move(move=md,
                params={"dlnv": jnp.asarray(dlnv, jnp.float32)},
                weight=weight)


def callback_density(view):
    """Mean number density N / V over chains (NPT observable)."""
    n, d = view.sys.pos.shape[-2:]
    v = view.sys.box ** d
    return jnp.mean(n / v)


# ---------------------------------------------------------------------------
# Event-chain MC for the smoothed IPL potential (exact factor events)
# ---------------------------------------------------------------------------

def ecmc_model(chain_length: float, params: PolyParams = PolyParams(),
               max_events_per_chain: int = 512, bisect_iters: int = 26):
    """Straight event chains for the polydisperse smoothed-IPL mixture.

    Same factorized-Metropolis scheme as ``lennard_jones.ecmc_model`` (see
    its docstring for the derivation), simplified by monotonicity: the
    smoothed IPL-12 is purely repulsive (u' < 0 on (0, x_c sigma_ij) with
    u = u' = 0 at the cut), so the cumulative uphill energy of a factor is
    nonzero ONLY while approaching — ``E(s) = u(r(s)) - u(r0)`` — and
    saturates at the impact parameter: ``E_max = u(b) - u(r0)``.  The
    branch inversion ``u(r_ev) = u(r0) + dE`` has no closed form (the
    C2-smoothing polynomial), so it runs ``bisect_iters`` vectorized
    bisection steps on the bracket [b, min(r0, rc)] — exact to float32 at
    26 iterations, fixed-shape, branch-free.

    Receding pairs never fire (no uphill), so lifting events always
    transfer forward: the ``excess`` statistic (signed separation at the
    event) is strictly positive, and
    ``beta P / rho = 1 + <excess per chain> / chain_length`` gives the
    swap-MC glass former's pressure for free.
    """
    from ..core.ecmc import EventChainModel

    c0, c2, c4 = params.coeffs()
    rcut_max = params.xc * params.d_max
    xc2 = params.xc ** 2

    def event_step(state, lift, key):
        pos0, box, beta = state.pos, state.box, state.beta
        n, dim = pos0.shape
        s_cap = jnp.maximum(box / 2.0 - rcut_max, 0.0)
        ka, kd, ku = jax.random.split(key, 3)
        a0 = jax.random.randint(ka, (), 0, n)
        d = jax.random.randint(kd, (), 0, dim)
        shift_v = jax.nn.one_hot(d, dim, dtype=pos0.dtype)
        idx = jnp.arange(n)

        def cond(carry):
            pos, a, budget, ncoll, niter, excess, k = carry
            return (budget > 0.0) & (niter < max_events_per_chain)

        def body(carry):
            pos, a, budget, ncoll, niter, excess, k = carry
            k, kthr = jax.random.split(k)
            mask_a = idx == a
            p = jnp.sum(jnp.where(mask_a[:, None], pos, 0.0), axis=0)
            d_a = jnp.sum(jnp.where(mask_a, state.diam, 0.0))
            rel = pos - p
            rel = rel - box * jnp.round(rel / box)
            along = jnp.dot(rel, shift_v, precision=_HIGHEST)  # no TF32
            r0sq = jnp.sum(rel * rel, axis=-1)
            w2 = jnp.maximum(r0sq - along * along, 0.0)

            sig = _sigma_ij(d_a, state.diam, params.eps)
            sig2 = jnp.maximum(sig * sig, 1e-12)

            def u_r2(r2):
                x2 = r2 / sig2
                inv2 = 1.0 / jnp.maximum(x2, 1e-12)
                inv12 = inv2 * inv2 * inv2
                inv12 = inv12 * inv12
                u = inv12 + c0 + c2 * x2 + c4 * x2 * x2
                return jnp.where(x2 < xc2, u, 0.0)

            u01 = jax.random.uniform(
                kthr, (n,), minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)
            d_e = -jnp.log(u01) / beta

            approaching = along > 0.0
            v = u_r2(r0sq) + d_e                    # target energy
            e_max = u_r2(w2)                        # u at impact parameter
            fires = approaching & (v < e_max) & jnp.logical_not(mask_a)

            # bisection for u(r_ev) = v on [b, min(r0, rc)] (u decreasing)
            lo = w2
            hi = jnp.minimum(r0sq, xc2 * sig2)

            def bis(_, lohi):
                lo, hi = lohi
                mid = 0.5 * (lo + hi)
                gt = u_r2(mid) >= v
                return (jnp.where(gt, mid, lo), jnp.where(gt, hi, mid))

            lo, hi = jax.lax.fori_loop(0, bisect_iters, bis, (lo, hi))
            r_ev2 = 0.5 * (lo + hi)
            s_j = along - jnp.sqrt(jnp.maximum(r_ev2 - w2, 0.0))
            s_j = jnp.where(fires, jnp.maximum(s_j, 0.0), jnp.inf)

            s_min = jnp.min(s_j)
            j_star = jnp.min(jnp.where(s_j == s_min, idx, n)).astype(
                jnp.int32)
            limit = jnp.minimum(budget, s_cap)
            hit = s_min < limit
            s = jnp.minimum(s_min, limit)
            new_p = (p + s * shift_v) % box
            pos = jnp.where(mask_a[:, None], new_p, pos)
            a = jnp.where(hit, j_star, a)
            along_hit = jnp.sum(jnp.where(idx == j_star, along, 0.0))
            excess = excess + jnp.where(hit, along_hit - s, 0.0)
            return (pos, a, budget - s, ncoll + hit.astype(jnp.int32),
                    niter + 1, excess, k)

        budget0 = jnp.asarray(chain_length, jnp.float32)
        pos, a, budget, ncoll, niter, excess, _ = jax.lax.while_loop(
            cond, body, (pos0, a0, budget0, jnp.zeros((), jnp.int32),
                         jnp.zeros((), jnp.int32), jnp.zeros((), jnp.float32),
                         ku))
        stats = {"t": chain_length - budget,
                 "chains": jnp.asarray(1, jnp.int32),
                 "collisions": ncoll,
                 "cap_hits": (budget > 0.0).astype(jnp.int32),
                 "excess": excess}
        return dataclasses.replace(state, pos=pos), lift, stats

    def init_lift(state, key):
        return {}

    return EventChainModel(init_lift=init_lift, event_step=event_step,
                           name="PolyIPLStraightECMC")


@functools.lru_cache(maxsize=None)
def cell_closures(params: PolyParams):
    """Static (pair_energy, rcut2_of, rcut_max) closures for the
    checkerboard cell-MC path (``ops/cell_mc.py``); attributes are the
    particle diameters."""
    c0, c2, c4 = params.coeffs()

    def pair_energy(r2, d_i, d_j):
        sig = _sigma_ij(d_i, d_j, params.eps)
        return _pair_energy(r2, sig, params, c0, c2, c4)

    def rcut2_of(d_i, d_j):
        sig = _sigma_ij(d_i, d_j, params.eps)
        return (params.xc * sig) ** 2

    # sigma_ij <= max(d_i, d_j) (the non-additive term only shrinks it)
    rcut_max = params.xc * params.d_max
    return pair_energy, rcut2_of, rcut_max


def callback_energy_per_particle(view):
    n = view.sys.pos.shape[-2]
    return jnp.mean(view.sys.energy) / n
