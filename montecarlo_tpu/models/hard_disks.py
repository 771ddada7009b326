"""2-D hard disks — the original event-chain Monte Carlo system.

Hard disks (diameter 1) in a periodic square box: the target measure is
uniform over non-overlapping configurations.  Two samplers share the state:

- :func:`displacement_move` — generic Metropolis through the engine
  (uniform square proposal; any overlap makes ``delta_log_target = -inf``,
  i.e. certain rejection).  The reference's propose/reject paradigm
  (``src/metropolis.jl:176-190``) on a hard-core system.
- :func:`ecmc_model` — straight event chains (Bernard, Krauth & Wilson
  2009): an active disk slides along +x or +y until it **collides** with
  another disk, which then becomes active; after a total chain displacement
  ``chain_length`` the lifting is resampled.  Rejection-free and
  non-reversible; the capability the reference names but does not implement
  (``/root/reference/README.md:27``).

Vectorised event computation: for an axis-aligned direction the collision
distance against every disk is one O(N) vector pass —
``s_j = u_j - sqrt(1 - w_j^2)`` with ``u`` the forward-wrapped parallel
separation and ``w`` the min-imaged perpendicular separation — followed by a
masked min-reduce.  No branches, no sorting, no neighbour lists; a full
event is a fixed-shape computation vmapped over chains.

Tests validate the two samplers against each other (same equilibrium
distribution) and the no-overlap invariant.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.ecmc import EventChainModel
from ..core.moves import Move, MoveDef, Policy
from ..core.system import SystemDef

#: event-chain projections run in full float32: a TF32 product keeps ~3
#: digits of a collision distance and breaks exact event times
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = [
    "HardDiskState",
    "make_system",
    "init_chains",
    "displacement_move",
    "volume_move",
    "ecmc_model",
    "ecmc_pressure",
    "min_pair_distance",
    "overlap_free",
    "callback_min_distance",
    "psi6",
    "callback_psi6",
    "cell_closures",
]

_DIAM = 1.0          # disk diameter (unit of length)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HardDiskState:
    """Single-chain state."""
    pos: jax.Array    # (N, 2) centers in [0, L)
    box: jax.Array    # () box edge L


def make_system() -> SystemDef:
    def log_target(state: HardDiskState):
        # uniform over valid configurations; hard core enforced by the moves
        return jnp.zeros((), jnp.float32)

    def frame(state: HardDiskState):
        return state.pos

    def format_frame(t, pos):
        n, d = pos.shape
        lines = [f"{t} {n}"]
        for k in range(n):
            lines.append(" ".join(repr(float(pos[k, a]))
                                  for a in range(d)))
        return "\n".join(lines)

    return SystemDef(name="HardDisks2D", log_target=log_target, frame=frame,
                     format_frame=format_frame)


def init_chains(n_chains: int, n_disks: int, eta: float,
                seed: int = 42, dim: int = 2) -> HardDiskState:
    """Square/cubic-lattice start at packing fraction ``eta`` (area
    fraction in 2-D, volume fraction in 3-D; must admit a non-overlapping
    lattice: eta < pi/4 ~ 0.785 in 2-D, < pi/6 ~ 0.524 in 3-D).  ``dim=3``
    gives HARD SPHERES — the displacement move, overlap checks, and the
    checkerboard cell path are all dimension-generic (psi6 and the
    straight-event-chain ECMC model remain 2-D)."""
    if dim == 2:
        content = n_disks * np.pi * (_DIAM / 2) ** 2
    else:
        content = n_disks * (np.pi / 6.0) * _DIAM ** 3
    box = float((content / eta) ** (1.0 / dim))
    side = int(np.ceil(n_disks ** (1.0 / dim)))
    spacing = box / side
    if spacing < _DIAM:
        raise ValueError(f"eta={eta} too dense for a lattice start")
    axes = [np.arange(side)] * dim
    grid = np.stack(np.meshgrid(*axes), axis=-1).reshape(-1, dim)[:n_disks]
    base = (grid + 0.5) * spacing
    jit_amp = 0.45 * (spacing - _DIAM)
    key = jax.random.key(seed)
    jitter = jit_amp * jax.random.uniform(
        key, (n_chains, n_disks, dim), minval=-1.0, maxval=1.0)
    pos = (jnp.asarray(base, jnp.float32)[None] + jitter) % box
    return HardDiskState(pos=pos,
                         box=jnp.full((n_chains,), box, jnp.float32))


# -- geometry ---------------------------------------------------------------

def _pair_dist2(state: HardDiskState):
    d = state.pos[:, None, :] - state.pos[None, :, :]
    d = d - state.box * jnp.round(d / state.box)
    r2 = jnp.sum(d * d, axis=-1)
    n = state.pos.shape[0]
    return jnp.where(jnp.eye(n, dtype=bool), jnp.inf, r2)


def min_pair_distance(state: HardDiskState, row_batch: int = None):
    """Minimum min-image center distance over all pairs (one chain).

    ``row_batch`` bounds peak memory to ``row_batch x N`` pair terms; the
    dense path materialises the full (N, N) matrix.  Auto-batches beyond
    N = 1024 (vmapped over chains the dense form OOMs at melting sizes).
    """
    n = state.pos.shape[0]
    if row_batch is None and n > 1024:
        row_batch = 256
    if row_batch is None or row_batch >= n:
        return jnp.sqrt(jnp.min(_pair_dist2(state)))

    def row_min(i):
        d = state.pos - state.pos[i]
        d = d - state.box * jnp.round(d / state.box)
        r2 = jnp.sum(d * d, axis=-1)
        return jnp.min(jnp.where(jnp.arange(n) == i, jnp.inf, r2))

    return jnp.sqrt(jnp.min(jax.lax.map(
        row_min, jnp.arange(n), batch_size=row_batch)))


def overlap_free(state: HardDiskState, tol: float = 1e-5):
    """True when no two disks overlap (one chain)."""
    return min_pair_distance(state) >= _DIAM - tol


def callback_min_distance(view):
    return jnp.mean(jax.vmap(min_pair_distance)(view.sys))


def psi6(state: HardDiskState, r_nbr: float = 1.4, row_batch: int = None):
    """Global bond-orientational order |<psi6>| of ONE chain.

    ``psi6_j = mean_k exp(6 i theta_jk)`` over neighbours within ``r_nbr``;
    returns ``|mean_j psi6_j|`` — the standard slow observable of the 2-D
    hard-disk melting problem (Bernard & Krauth 2011), used for the
    ECMC-vs-Metropolis autocorrelation benchmark (``tools/bench_ecmc.py``).

    ``row_batch`` bounds peak memory to ``row_batch x N`` pair terms (the
    dense path materialises (N, N, 2) displacements — vmapped over chains
    that OOMs at melting-problem sizes); auto-batches beyond N = 1024 like
    :func:`min_pair_distance`, so every caller is safe by default.
    """
    n = state.pos.shape[0]
    if row_batch is None and n > 1024:
        row_batch = 256

    def rows_psi(pos_rows):
        d = pos_rows[:, None, :] - state.pos[None, :, :]
        d = d - state.box * jnp.round(d / state.box)
        r2 = jnp.sum(d * d, axis=-1)
        # self-pairs have r2 == 0 exactly; exclude them by distance
        nbr = (r2 < r_nbr * r_nbr) & (r2 > 1e-12)
        theta = jnp.arctan2(d[..., 1], d[..., 0])
        c = jnp.where(nbr, jnp.cos(6.0 * theta), 0.0)
        s = jnp.where(nbr, jnp.sin(6.0 * theta), 0.0)
        cnt = jnp.maximum(jnp.sum(nbr, axis=1), 1)
        return (jnp.sum(c, axis=1) / cnt, jnp.sum(s, axis=1) / cnt)

    if row_batch is None or row_batch >= n:
        pj_c, pj_s = rows_psi(state.pos)
    else:
        pj_c, pj_s = jax.lax.map(
            lambda i: jax.tree_util.tree_map(
                lambda a: a[0], rows_psi(state.pos[i][None])),
            jnp.arange(n), batch_size=row_batch)
    return jnp.sqrt(jnp.mean(pj_c) ** 2 + jnp.mean(pj_s) ** 2)


def callback_psi6(view):
    """Chain-mean |psi6| (slow orientational observable; auto-row-batched
    at melting-problem sizes to stay within HBM)."""
    return jnp.mean(jax.vmap(psi6)(view.sys))


def cell_closures():
    """Static (pair_energy, rcut2_of, rcut_max) closures for the
    checkerboard cell-MC path (``ops/cell_mc.py``).

    A hard core as an INFINITE energy wall: any neighbour inside the
    diameter contributes ``+inf``, so an overlapping proposal has
    ``-beta dE = -inf`` and ``log(u) < -inf`` is False for EVERY uniform
    draw — including the exact-0.0 draw whose ``log`` is also ``-inf`` (a
    finite wall like 1e30 would accept there, breaking the hard core about
    once per 2^23 attempts).  No NaNs arise: the current configuration is
    overlap-free so ``e_old`` is always exactly 0, never inf, and rejected
    infinities are discarded by the accept select before touching the
    energy accumulator.  Attributes are unused (pass zeros).
    """

    def pair_energy(r2, a_i, a_j):
        return jnp.full_like(r2, jnp.inf)

    def rcut2_of(a_i, a_j):
        return _DIAM * _DIAM

    return pair_energy, rcut2_of, _DIAM


# -- Metropolis displacement move ------------------------------------------

class UniformSquare(Policy):
    """Uniform particle pick + uniform square displacement (symmetric)."""

    def sample(self, params, key, state):
        ki, kd = jax.random.split(key)
        n, d = state.pos.shape
        i = jax.random.randint(ki, (), 0, n)
        delta = params["delta"] * jax.random.uniform(
            kd, (d,), minval=-1.0, maxval=1.0)
        return {"i": i, "delta": delta}

    def log_density(self, params, action, state):
        n, dim = state.pos.shape
        d = params["delta"]
        return (-dim * jnp.log(2.0 * d)
                - jnp.log(jnp.asarray(float(n), jnp.result_type(d))))


def displacement_move(delta: float, weight: float = 1.0) -> Move:
    """Local move with hard-core rejection: overlap => dlogp = -inf."""

    def apply(state: HardDiskState, action):
        i, dlt = action["i"], action["delta"]
        n = state.pos.shape[0]
        mask = jnp.arange(n) == i
        old = jnp.sum(jnp.where(mask[:, None], state.pos, 0.0), axis=0)
        new = (old + dlt) % state.box
        d = state.pos - new
        d = d - state.box * jnp.round(d / state.box)
        r2 = jnp.sum(d * d, axis=-1)
        overlap = jnp.any(jnp.where(mask, False, r2 < _DIAM * _DIAM))
        pos = jnp.where(mask[:, None], new, state.pos)
        new_state = dataclasses.replace(state, pos=pos)
        dlogp = jnp.where(overlap, -jnp.inf, 0.0)
        return new_state, dlogp

    def invert(action, new_state):
        return {"i": action["i"], "delta": -action["delta"]}

    def reward(action, new_state):
        return jnp.sum(action["delta"] ** 2)

    md = MoveDef(name="HardDiskDisplacement", policy=UniformSquare(),
                 apply=apply, invert=invert, reward=reward,
                 kind="hard_disk_displacement_2d")
    return Move(move=md, params={"delta": jnp.asarray(delta, jnp.float32)},
                weight=weight)


class _UniformLogVolume(Policy):
    """Symmetric uniform step in ln V (hard-core NPT)."""

    def sample(self, params, key, state):
        return params["dlnv"] * jax.random.uniform(
            key, (), minval=-1.0, maxval=1.0)

    def log_density(self, params, action, state):
        return -jnp.log(2.0 * params["dlnv"])


def volume_move(dlnv: float, beta_pressure: float,
                weight: float = 1.0) -> Move:
    """Isotropic ln-V volume move for the HARD-CORE NPT ensemble
    (constant-pressure hard disks / spheres — the classic crystallization
    protocol).  Only the product beta*P enters (there is no energy scale):

        dlog pi = -betaP dV + (N + 1) delta,   overlap => -inf.

    On the cell path this runs as a volume substep for free: the infinite
    energy wall makes the full cell energy at the proposed box exactly 0
    (valid) or +inf (overlap => certain rejection)."""

    def apply(state: HardDiskState, delta):
        n, d = state.pos.shape
        scale = jnp.exp(delta / d)
        new = dataclasses.replace(state, pos=state.pos * scale,
                                  box=state.box * scale)
        overlap = min_pair_distance(new) < _DIAM
        v_old = state.box ** d
        d_v = v_old * (jnp.exp(delta) - 1.0)
        dlogp = jnp.where(overlap, -jnp.inf,
                          -beta_pressure * d_v + (n + 1) * delta)
        return new, dlogp

    def invert(delta, new_state):
        return -delta

    def reward(delta, new_state):
        return delta * delta

    md = MoveDef(name="HardDiskVolume", policy=_UniformLogVolume(),
                 apply=apply, invert=invert, reward=reward,
                 kind="hard_disk_volume", aux=(None, float(beta_pressure)))
    return Move(move=md, params={"dlnv": jnp.asarray(dlnv, jnp.float32)},
                weight=weight)


# -- straight event-chain model ---------------------------------------------

def ecmc_model(chain_length: float,
               max_events_per_chain: int = 256) -> EventChainModel:
    """Straight event chains along the +axis directions (2-D or 3-D —
    hard spheres run the same O(N) pass: the collision geometry only uses
    the squared perpendicular distance ``w2 = r0^2 - along^2``).

    One ``event_step`` runs one FULL chain: a fresh (active disk, direction)
    pair is drawn, then the active disk slides and the lifting transfers at
    collisions (``lax.while_loop``) until the total chain displacement
    reaches ``chain_length``.  Sampling at chain ends is the unbiased
    convention (Bernard-Krauth-Wilson): states observed at *collision* times
    over-represent at-contact configurations (the active pair sits exactly
    at distance 1), which visibly biases contact-sensitive observables.

    Per collision: distances ``s_j`` against all disks along the direction
    are one O(N) closed-form vector pass — ``s_j = u_j - sqrt(1 - w_j^2)``
    with ``u`` forward-wrapped (the just-hit partner lands a full period
    away, so no epsilon exclusions) and ``w`` min-imaged — followed by a
    masked min-reduce.

    ``max_events_per_chain`` statically bounds the while loop; a chain that
    hits the cap stops early and increments ``cap_hits`` (tests assert it
    stays 0 — size the cap at several ``chain_length / mean_free_path``).

    Statistics: ``t`` (displacement), ``chains``, ``collisions``,
    ``cap_hits``, and ``excess`` — the sum of projected contact separations
    sqrt(1 - w²) over collisions, giving the ECMC pressure estimator
    (Michel, Kapfer & Krauth 2014):

        beta P / rho = 1 + <excess per chain> / chain_length.
    """

    def init_lift(state, key):
        return {}          # chain lifting variables are drawn per chain

    def event_step(state, lift, key):
        pos0, box = state.pos, state.box
        n, dim = pos0.shape
        ka, kd = jax.random.split(key)
        a0 = jax.random.randint(ka, (), 0, n)
        d = jax.random.randint(kd, (), 0, dim)
        shift = jax.nn.one_hot(d, dim, dtype=pos0.dtype)
        idx = jnp.arange(n)

        def cond(carry):
            pos, a, budget, ncoll, niter, excess = carry
            return (budget > 0.0) & (niter < max_events_per_chain)

        def body(carry):
            pos, a, budget, ncoll, niter, excess = carry
            mask_a = idx == a
            p = jnp.sum(jnp.where(mask_a[:, None], pos, 0.0), axis=0)
            rel = pos - p
            along = jnp.dot(rel, shift, precision=_HIGHEST)
            relm = rel - box * jnp.round(rel / box)   # min-imaged
            alongm = jnp.dot(relm, shift, precision=_HIGHEST)
            w2 = jnp.maximum(jnp.sum(relm * relm, axis=-1)
                             - alongm * alongm, 0.0)
            u = along % box                           # forward-wrapped
            hittable = jnp.logical_not(mask_a) & (w2 < _DIAM * _DIAM)
            root = jnp.sqrt(jnp.maximum(_DIAM * _DIAM - w2, 0.0))
            s_j = u - root
            # A disk "behind" along the wrapped axis is hit a period later —
            # but an at-contact partner whose s_j rounds to -1ulp (e.g. the
            # budget expired exactly at contact and the disk was re-picked
            # with the same direction) is a REAL immediate collision: wrapping
            # it would let the active disk tunnel through and leave a
            # permanent overlap.  Treat s_j in [-eps, 0) as contact (0).
            eps_c = jnp.float32(1e-5)
            s_j = jnp.where(s_j < -eps_c, s_j + box,
                            jnp.maximum(s_j, 0.0))
            s_j = jnp.where(hittable, s_j, jnp.inf)
            s_min = jnp.min(s_j)
            # lowest index attaining the min (robust against float ties)
            j_star = jnp.min(jnp.where(s_j == s_min, idx, n)).astype(
                jnp.int32)

            hit = s_min < budget
            s = jnp.minimum(s_min, budget)
            new_p = (p + s * shift) % box
            pos = jnp.where(mask_a[:, None], new_p, pos)
            a = jnp.where(hit, j_star, a)
            # projected contact separation of the hit pair (pressure term)
            root_hit = jnp.sum(jnp.where(idx == j_star, root, 0.0))
            excess = excess + jnp.where(hit, root_hit, 0.0)
            return (pos, a, budget - s, ncoll + hit.astype(jnp.int32),
                    niter + 1, excess)

        budget0 = jnp.asarray(chain_length, jnp.float32)
        pos, a, budget, ncoll, niter, excess = jax.lax.while_loop(
            cond, body, (pos0, a0, budget0, jnp.zeros((), jnp.int32),
                         jnp.zeros((), jnp.int32),
                         jnp.zeros((), jnp.float32)))
        # event counts accumulate as int32 (exact up to 2^31); the float32
        # sums (t, excess) keep full precision up to ~2^24 per chain —
        # beyond ~10^7 events per chain, read them out periodically
        stats = {"t": chain_length - budget,
                 "chains": jnp.asarray(1, jnp.int32),
                 "collisions": ncoll,
                 "cap_hits": (budget > 0.0).astype(jnp.int32),
                 "excess": excess}
        return dataclasses.replace(state, pos=pos), lift, stats

    return EventChainModel(init_lift=init_lift, event_step=event_step,
                           name="HardDiskStraightECMC")


def ecmc_pressure(stats, chain_length: float, burn_excess=None,
                  burn_chains=None):
    """Reduced pressure beta P / rho from accumulated ECMC statistics.

    ``beta P / rho = 1 + <excess per chain> / chain_length`` (Michel,
    Kapfer & Krauth 2014).  Pass the ``ecmc`` slice's ``stats`` pytree; to
    discard equilibration, subtract a snapshot (``burn_excess``,
    ``burn_chains``) taken at the end of the burn-in.
    """
    import numpy as _np
    excess = _np.asarray(stats["excess"], _np.float64).sum()
    chains = _np.asarray(stats["chains"], _np.float64).sum()
    if burn_excess is not None:
        excess -= _np.asarray(burn_excess, _np.float64).sum()
        chains -= _np.asarray(burn_chains, _np.float64).sum()
    return 1.0 + excess / (chains * chain_length)
