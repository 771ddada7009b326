"""2-D Lennard-Jones particle system (ParticlesMC-style).

The reference keeps particle systems in companion repos (README.md:26-31
points at TheDisorderedOrganization/ParticlesMC); BASELINE.json makes a 2-D
LJ system with local displacement + swap moves a first-class benchmark config,
so it ships here as a model family.

Vectorised design: positions are a single ``(N, 2)`` array per chain (chain
axis via vmap/sharding), the per-move energy change is an O(N) vectorized
min-image row sum (the cached-``Δe`` trick of ``perform_action_cached!``,
``src/metropolis.jl:119``, generalised: total energy is carried in the state
and updated incrementally), and species-dependent coefficients are gathered
from (2, 2) tables — Kob-Andersen-style binary mixtures for swap moves.
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
    "LJState",
    "LJParams",
    "make_system",
    "init_chains",
    "lj_displacement_move",
    "lj_swap_move",
    "lj_volume_move",
    "total_energy",
    "virial_pressure",
    "callback_energy_per_particle",
    "callback_pressure",
    "callback_density",
    "ecmc_model",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LJState:
    """Single-chain state."""
    pos: jax.Array       # (N, 2) positions in [0, L)
    species: jax.Array   # (N,) int32 species labels (0=A, 1=B)
    beta: jax.Array      # () inverse temperature
    energy: jax.Array    # () cached total potential energy
    box: jax.Array       # () periodic box edge L


@dataclasses.dataclass(frozen=True)
class LJParams:
    """Static interaction table (Kob-Andersen defaults).

    eps/sig are 2x2 species tables; rcut is in units of sig_ab (truncated &
    shifted so u(rcut)=0).
    """
    eps: tuple = ((1.0, 1.5), (1.5, 0.5))
    sig: tuple = ((1.0, 0.8), (0.8, 0.88))
    rcut: float = 2.5

    def tables(self):
        return (jnp.asarray(self.eps, jnp.float32),
                jnp.asarray(self.sig, jnp.float32))

    def coeffs(self, s_i, s_j):
        """Species-pair (eps, sig) via arithmetic select — no gathers from
        tiny tables inside the vectorised row."""
        same = s_i == s_j
        is_a = s_i == 0
        eps = jnp.where(
            same, jnp.where(is_a, self.eps[0][0], self.eps[1][1]),
            self.eps[0][1])
        sig = jnp.where(
            same, jnp.where(is_a, self.sig[0][0], self.sig[1][1]),
            self.sig[0][1])
        return eps, sig


def _pair_energy(r2, eps, sig, rcut):
    """Truncated-and-shifted LJ on squared distances (vectorized)."""
    sig2 = sig * sig
    rc2 = (rcut * sig) ** 2
    # avoid div-by-zero at the self-distance slot; masked out by caller
    inv = sig2 / jnp.maximum(r2, 1e-12)
    i6 = inv * inv * inv
    u = 4.0 * eps * (i6 * i6 - i6)
    ic = 1.0 / (rcut * rcut)
    ic6 = ic * ic * ic
    ushift = 4.0 * eps * (ic6 * ic6 - ic6)
    return jnp.where(r2 < rc2, u - ushift, 0.0)


def _min_image_r2(pos, x, box):
    """Squared min-image distances from point ``x`` to every row of ``pos``."""
    d = pos - x
    d = d - box * jnp.round(d / box)
    return jnp.sum(d * d, axis=-1)


def _row_energy(state: LJState, x, s_i, mask, params: LJParams):
    """Interaction energy of a (virtual) particle at ``x`` with species
    ``s_i`` against all particles (rows where ``mask`` is True excluded)."""
    r2 = _min_image_r2(state.pos, x, state.box)
    eps, sig = params.coeffs(s_i, state.species)
    u = _pair_energy(r2, eps, sig, params.rcut)
    return jnp.sum(jnp.where(mask, 0.0, u))


def total_energy(state: LJState, params: LJParams, row_batch: int = None):
    """Full O(N^2) energy — used for initialisation and cache validation.

    ``row_batch`` bounds peak memory to ``row_batch x N`` pair terms (the
    dense path materialises the full ``(N, N, 2)`` displacement tensor,
    which vmapped over many chains can exceed HBM); results are identical.
    """
    n = state.pos.shape[0]
    if row_batch is None or row_batch >= n:
        d = state.pos[:, None, :] - state.pos[None, :, :]
        d = d - state.box * jnp.round(d / state.box)
        r2 = jnp.sum(d * d, axis=-1)
        eps, sig = params.coeffs(state.species[:, None],
                                 state.species[None, :])
        u = _pair_energy(r2, eps, sig, params.rcut)
        mask = ~jnp.eye(n, dtype=bool)
        return 0.5 * jnp.sum(jnp.where(mask, u, 0.0))

    idx = jnp.arange(n)

    def row_e(i):
        x_i = state.pos[i]
        s_i = state.species[i]
        return _row_energy(state, x_i, s_i, idx == i, params)

    return 0.5 * jnp.sum(jax.lax.map(row_e, idx, batch_size=row_batch))


def make_system(params: LJParams = LJParams()) -> SystemDef:
    def log_target(state: LJState):
        return -state.beta * state.energy

    def frame(state: LJState):
        return {"pos": state.pos, "species": state.species,
                "energy": state.energy}

    def format_frame(t, fr):
        n, d = fr["pos"].shape
        lines = [f"{t} {n} {float(fr['energy'])!r}"]
        for k in range(n):
            coords = " ".join(repr(float(fr["pos"][k, a]))
                              for a in range(d))
            lines.append(f"{int(fr['species'][k])} {coords}")
        return "\n".join(lines)

    def refresh(state: LJState):
        # revalidate the incremental-ΔE energy cache (float drift bound);
        # row-batched so the engine's vmap over chains stays within HBM
        n = state.pos.shape[0]
        rb = None if n <= 256 else 64
        return dataclasses.replace(
            state, energy=total_energy(state, params, row_batch=rb))

    return SystemDef(name="LennardJones2D", log_target=log_target,
                     frame=frame, format_frame=format_frame,
                     refresh=refresh)


def init_chains(n_chains: int, n_particles: int, rho: float, beta: float,
                frac_b: float = 0.0, seed: int = 42,
                params: LJParams = LJParams(), dim: int = 2) -> LJState:
    """Chain-stacked initial state: square/cubic lattice + small jitter
    (avoids overlaps), species assigned round-robin to hit ``frac_b``.
    ``dim`` selects the spatial dimension (2 default; 3-D runs through the
    generic engine at small N and the 3-D cell-MC path at large N — only
    the Pallas row kernels are 2-D)."""
    box = float((n_particles / rho) ** (1.0 / dim))
    side = int(np.ceil(n_particles ** (1.0 / dim)))
    spacing = box / side
    axes = [np.arange(side)] * dim
    grid = np.stack(np.meshgrid(*axes), axis=-1).reshape(-1, dim)
    grid = grid[:n_particles]
    base = (grid + 0.5) * spacing

    n_b = int(round(frac_b * n_particles))
    species = np.zeros(n_particles, np.int32)
    if n_b:
        species[np.linspace(0, n_particles - 1, n_b).astype(int)] = 1

    key = jax.random.key(seed)
    jitter = (0.1 * spacing) * jax.random.uniform(
        key, (n_chains, n_particles, dim), minval=-1.0, maxval=1.0)
    pos = (jnp.asarray(base, jnp.float32)[None] + jitter) % box

    state = LJState(
        pos=pos,
        species=jnp.broadcast_to(jnp.asarray(species), (n_chains, n_particles)),
        beta=jnp.full((n_chains,), beta, jnp.float32),
        energy=jnp.zeros((n_chains,), jnp.float32),
        box=jnp.full((n_chains,), box, jnp.float32),
    )
    # chain-batched map with row-batched inner energies: a full vmap would
    # materialise an (M, N, N, 2) displacement tensor (8.6 GB at
    # M = N = 1024) and OOM the chip; budget ~128M pair terms per launch
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
    """Uniform particle pick + isotropic Gaussian displacement (any spatial
    dimension — the name keeps the original 2-D API).

    The particle-selection factor 1/N is identical forward/backward and the
    Gaussian is symmetric, so logq_f == logq_b — both are still computed by
    the generic kernel (ref ``mc_step!`` recipe) and cancel in the ratio.
    """

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


def lj_displacement_move(sigma: float, weight: float = 1.0,
                         params: LJParams = LJParams()) -> Move:
    """Local displacement with O(N) incremental ΔE."""

    def apply(state: LJState, action):
        i, delta = action["i"], action["delta"]
        n = state.pos.shape[0]
        mask = jnp.arange(n) == i
        # one-hot reduce instead of dynamic gather, masked select instead of
        # scatter: both stay one fused vector pass
        old = jnp.sum(jnp.where(mask[:, None], state.pos, 0.0), axis=0)
        s_i = jnp.sum(jnp.where(mask, state.species, 0)).astype(
            state.species.dtype)
        new = old + delta
        e_old = _row_energy(state, old, s_i, mask, params)
        e_new = _row_energy(state, new, s_i, mask, params)
        d_e = e_new - e_old
        pos = jnp.where(mask[:, None], new % state.box, state.pos)
        new_state = dataclasses.replace(
            state, pos=pos, energy=state.energy + d_e)
        return new_state, -state.beta * d_e

    def invert(action, new_state):
        return {"i": action["i"], "delta": -action["delta"]}

    def reward(action, new_state):
        return jnp.sum(action["delta"] ** 2)

    md = MoveDef(name="LJDisplacement", policy=GaussianDisplacement2D(),
                 apply=apply, invert=invert, reward=reward,
                 kind="lj_displacement_2d", aux=params)
    return Move(move=md, params={"sigma": jnp.asarray(sigma, jnp.float32)},
                weight=weight)


class UniformPairSwap(Policy):
    """Pick an (A, B) pair uniformly; proposal is symmetric (self-inverse),
    so logq_f == logq_b by construction."""

    def sample(self, params, key, state):
        ki, kj = jax.random.split(key)
        n = state.pos.shape[0]
        is_b = state.species == 1
        n_b = jnp.sum(is_b)
        n_a = n - n_b
        # index of the k-th A (resp. B) particle via cumulative counts
        ka = jax.random.randint(ki, (), 0, jnp.maximum(n_a, 1))
        kb = jax.random.randint(kj, (), 0, jnp.maximum(n_b, 1))
        a_rank = jnp.cumsum(~is_b) - 1
        b_rank = jnp.cumsum(is_b) - 1
        i = jnp.argmax((a_rank == ka) & (~is_b))
        j = jnp.argmax((b_rank == kb) & is_b)
        return {"i": i, "j": j}

    def log_density(self, params, action, state):
        is_b = state.species == 1
        n_b = jnp.sum(is_b).astype(jnp.float32)
        n_a = is_b.shape[0] - n_b
        return -jnp.log(jnp.maximum(n_a, 1.0)) - jnp.log(
            jnp.maximum(n_b, 1.0))


def lj_swap_move(weight: float = 1.0,
                 params: LJParams = LJParams()) -> Move:
    """Species-swap move: exchange the species labels of an (A, B) pair.

    ΔE is two O(N) row updates (remove both old identities, add both new),
    with the i–j pair interaction corrected once.
    """

    def apply(state: LJState, action):
        i, j = action["i"], action["j"]
        n = state.pos.shape[0]
        idx = jnp.arange(n)
        mask_i, mask_j = idx == i, idx == j
        mask_ij = mask_i | mask_j
        gather_s = lambda m: jnp.sum(
            jnp.where(m, state.species, 0)).astype(state.species.dtype)
        gather_x = lambda m: jnp.sum(
            jnp.where(m[:, None], state.pos, 0.0), axis=0)
        s_i, s_j = gather_s(mask_i), gather_s(mask_j)
        x_i, x_j = gather_x(mask_i), gather_x(mask_j)
        # old identity rows (exclude both i and j; the ij pair handled apart)
        e_old = (_row_energy(state, x_i, s_i, mask_ij, params)
                 + _row_energy(state, x_j, s_j, mask_ij, params))
        e_new = (_row_energy(state, x_i, s_j, mask_ij, params)
                 + _row_energy(state, x_j, s_i, mask_ij, params))
        # i-j pair: species pair is unchanged by the swap (s_i,s_j)->(s_j,s_i)
        # and eps/sig tables are symmetric, so its energy cancels in ΔE.
        d_e = e_new - e_old
        species = jnp.where(mask_i, s_j,
                            jnp.where(mask_j, s_i, state.species))
        new_state = dataclasses.replace(
            state, species=species, energy=state.energy + d_e)
        return new_state, -state.beta * d_e

    def invert(action, new_state):
        return action  # self-inverse

    def reward(action, new_state):
        return jnp.asarray(1.0, jnp.float32)

    md = MoveDef(name="LJSwap", policy=UniformPairSwap(),
                 apply=apply, invert=invert, reward=reward,
                 kind="lj_swap", aux=params)
    return Move(move=md, params={"dummy": jnp.zeros(())}, weight=weight)


def callback_energy_per_particle(view):
    n = view.sys.pos.shape[-2]
    return jnp.mean(view.sys.energy) / n


@functools.lru_cache(maxsize=None)
def cell_closures(params: LJParams):
    """Static (pair_energy, rcut2_of, rcut_max) closures for the
    checkerboard cell-MC path (``ops/cell_mc.py``).  Attributes are the
    species labels as float32; the pair energy is the same
    truncated-and-shifted KA form as :func:`_pair_energy` (cutoff gating is
    the caller's job via ``rcut2_of``)."""

    def _tables(s_i, s_j):
        same = s_i == s_j
        is_a = s_i < 0.5
        eps = jnp.where(same,
                        jnp.where(is_a, params.eps[0][0], params.eps[1][1]),
                        params.eps[0][1])
        sig = jnp.where(same,
                        jnp.where(is_a, params.sig[0][0], params.sig[1][1]),
                        params.sig[0][1])
        return eps, sig

    def pair_energy(r2, s_i, s_j):
        eps, sig = _tables(s_i, s_j)
        sig2 = sig * sig
        inv = sig2 / jnp.maximum(r2, 1e-12)
        i6 = inv * inv * inv
        ic = 1.0 / (params.rcut * params.rcut)
        ic6 = ic * ic * ic
        return 4.0 * eps * ((i6 * i6 - i6) - (ic6 * ic6 - ic6))

    def rcut2_of(s_i, s_j):
        _, sig = _tables(s_i, s_j)
        return (params.rcut * sig) ** 2

    rcut_max = params.rcut * float(np.max(np.asarray(params.sig)))
    return pair_energy, rcut2_of, rcut_max


def virial_pressure(state: LJState, params: LJParams = LJParams(),
                    row_batch: int = None):
    """Instantaneous virial pressure of ONE chain (any dimension d).

    ``P = rho / beta + W / (d V)`` with the pair virial
    ``w(r) = -r du/dr = 24 eps [2 (sig/r)^12 - (sig/r)^6]`` summed over pairs
    inside the cutoff.  Exact for the truncated-and-shifted potential the
    sampler targets: the shift keeps u continuous at rc, so there is no
    impulsive cutoff term, and no tail correction applies (the ensemble IS
    the truncated model).  This is the NVT side of the NPT/NVT
    equation-of-state cross-check (``tests/test_npt.py``).

    ``row_batch`` bounds peak memory to ``row_batch x N`` pair terms (the
    dense path materialises the full ``(N, N, dim)`` displacement tensor,
    which vmapped over chains OOMs at large N); results are identical.
    """
    n, dim = state.pos.shape

    def rows_w(x_i, s_i):
        # (R, N) pair virials of probe rows x_i against all particles
        d = state.pos[None, :, :] - x_i[:, None, :]
        d = d - state.box * jnp.round(d / state.box)
        r2 = jnp.sum(d * d, axis=-1)
        eps, sig = params.coeffs(s_i[:, None], state.species[None, :])
        sig2 = sig * sig
        rc2 = (params.rcut * sig) ** 2
        inv = sig2 / jnp.maximum(r2, 1e-12)
        i6 = inv * inv * inv
        w = 24.0 * eps * (2.0 * i6 * i6 - i6)
        return jnp.where(r2 < rc2, w, 0.0)

    if row_batch is None or row_batch >= n:
        w = rows_w(state.pos, state.species)
        mask = ~jnp.eye(n, dtype=bool)
        w_sum = 0.5 * jnp.sum(jnp.where(mask, w, 0.0))
    else:
        idx = jnp.arange(n)

        def row(i):
            w = rows_w(state.pos[i][None], state.species[i][None])[0]
            return jnp.sum(jnp.where(idx == i, 0.0, w))

        w_sum = 0.5 * jnp.sum(jax.lax.map(row, idx, batch_size=row_batch))
    v = state.box ** dim
    rho = n / v
    return rho / state.beta + w_sum / (dim * v)


def callback_pressure(view, params: LJParams = LJParams()):
    """Mean instantaneous virial pressure over chains (NVT observable).

    Auto row-batches beyond N ~ 1024 so the vmap over chains stays within
    HBM (same policy as ``total_energy`` / ``refresh``)."""
    n = view.sys.pos.shape[-2]
    rb = None if n <= 1024 else 256
    return jnp.mean(jax.vmap(
        lambda s: virial_pressure(s, params, row_batch=rb))(view.sys))


# ---------------------------------------------------------------------------
# NPT ensemble: volume moves
# ---------------------------------------------------------------------------

class UniformLogVolume(Policy):
    """Symmetric uniform step in ln V (standard NPT volume proposal)."""

    def sample(self, params, key, state):
        return params["dlnv"] * jax.random.uniform(
            key, (), minval=-1.0, maxval=1.0)

    def log_density(self, params, action, state):
        return -jnp.log(2.0 * params["dlnv"])


def lj_volume_move(dlnv: float, pressure: float, weight: float = 1.0,
                   params: LJParams = LJParams()) -> Move:
    """Isotropic volume-scaling move — the NPT ensemble (a capability the
    reference engine does not reach: its state never changes geometry).

    Samples ``delta = d ln V`` uniformly; the box edge scales by
    ``exp(delta/dim)`` and every position with it, the energy is
    recomputed in full (O(N^2) — volume moves are scheduled rarely), and
    the NPT acceptance for ln-V sampling is

        dlog pi = -beta (dE + P dV) + (N + 1) delta.

    Validated in the ideal-gas limit (eps = 0): <V> = (N + 1)/(beta P)
    exactly (``tests/test_npt.py``).
    """

    def apply(state: LJState, delta):
        n, d = state.pos.shape
        scale = jnp.exp(delta / d)
        box_new = state.box * scale
        pos_new = state.pos * scale
        new_state0 = dataclasses.replace(state, pos=pos_new, box=box_new)
        e_new = total_energy(new_state0, params)
        d_e = e_new - state.energy
        v_old = state.box ** d
        d_v = v_old * (jnp.exp(delta) - 1.0)
        dlogp = (-state.beta * (d_e + pressure * d_v)
                 + (n + 1) * delta)
        return dataclasses.replace(new_state0, energy=e_new), dlogp

    def invert(delta, new_state):
        return -delta

    def reward(delta, new_state):
        return delta * delta

    # aux carries (interaction table, pressure): the cell-MC planner needs
    # the target pressure to run volume substeps on the bound state
    md = MoveDef(name="LJVolume", policy=UniformLogVolume(),
                 apply=apply, invert=invert, reward=reward,
                 kind="lj_volume", aux=(params, float(pressure)))
    return Move(move=md,
                params={"dlnv": jnp.asarray(dlnv, jnp.float32)},
                weight=weight)


def callback_density(view):
    """Mean number density N / V over chains (NPT observable)."""
    n, d = view.sys.pos.shape[-2:]
    v = view.sys.box ** d
    return jnp.mean(n / v)


# ---------------------------------------------------------------------------
# Event-chain MC for the soft LJ potential (exact factor events)
# ---------------------------------------------------------------------------

def ecmc_model(chain_length: float, params: LJParams = LJParams(),
               max_events_per_chain: int = 512):
    """Straight event chains for the truncated-and-shifted LJ mixture —
    the soft-potential ECMC the reference names as its extension target
    (``/root/reference/README.md:27``) beyond hard disks.

    Factorized-Metropolis ECMC (Peters & de With 2012; Michel, Kapfer &
    Krauth 2014): each pair (i, j) is an independent factor whose event
    fires when the CUMULATIVE UPHILL energy of that pair along the active
    particle's path reaches an Exp(1)/beta threshold.  For straight-line
    motion past a radial potential the uphill energy is piecewise monotone
    in r (approach: uphill only inside the minimum r_m = 2^(1/6) sigma;
    recede: uphill only outside r_m, saturating at the cutoff), and the
    truncated-shifted LJ inverts in CLOSED FORM on each branch
    (``4 eps (y^2 - y) = v + c`` with ``y = (sigma/r)^6`` is a quadratic),
    so per event one O(N) vector pass yields every factor's exact event
    distance — no thinning, no discretisation:

    - approach (dx > 0): max uphill ``E1 = u(b) - u(a1)`` with impact
      parameter ``b = |w|`` and ``a1 = min(r0, r_m)``; a threshold below
      E1 fires at ``r_ev`` from the CORE branch
      (``y = (1 + sqrt(1 + (v+c)/eps)) / 2``),
      ``s = dx - sqrt(r_ev^2 - w^2)``.
    - recede: uphill climbs out of the well from ``a2 = max(b_or_r0, r_m)``
      up to the cutoff, ``E2 = -u(a2)``; fires at ``r_ev`` from the OUTER
      branch (``y = (1 - sqrt(...)) / 2``),
      ``s = dx + sqrt(r_ev^2 - w^2)``.
    - otherwise the factor cannot fire before the pair leaves range.

    The per-iteration advance is capped at ``box/2 - rcut`` so min-image
    coordinates stay unambiguous; re-drawing the factor thresholds after a
    no-event advance is EXACT by the memorylessness of the exponential.
    The lifting transfers to the arg-min factor; every move is accepted.
    Dimension-generic (2-D/3-D): only ``w^2 = r0^2 - along^2`` enters.

    The cached ``state.energy`` is NOT incrementally tracked (events don't
    need it); the system's ``refresh`` hook revalidates it at every
    observation point, so recorded energies are exact.

    Statistics: ``t`` (distance), ``chains``, ``collisions`` (lifting
    transfers), ``cap_hits`` (iteration-cap truncations; keep at 0), and
    ``excess`` — the sum of signed along-direction separations at lifting
    events, giving the MKK pressure estimator
    ``beta P / rho = 1 + <excess per chain> / chain_length``.
    """
    from ..core.ecmc import EventChainModel

    rcut_max = params.rcut * float(np.max(np.asarray(params.sig)))
    xc2 = 1.0 / (params.rcut * params.rcut)     # (sigma / rcut_ij)^2
    xc6 = xc2 * xc2 * xc2
    # u_ts(r) = 4 eps [(sig/r)^12 - (sig/r)^6] - c_eps,  c_eps = 4 eps c0
    c0 = xc6 * xc6 - xc6                        # (negative) shift / (4 eps)

    def event_step(state, lift, key):
        pos0, box, beta = state.pos, state.box, state.beta
        n, dim = pos0.shape
        # advance cap keeps min-image coordinates unambiguous per
        # iteration; requires box > 2 rcut_max (a too-small box deadlocks
        # into the iteration cap, surfaced by cap_hits)
        s_cap = jnp.maximum(box / 2.0 - rcut_max, 0.0)
        ka, kd, ku = jax.random.split(key, 3)
        a0 = jax.random.randint(ka, (), 0, n)
        d = jax.random.randint(kd, (), 0, dim)
        shift_v = jax.nn.one_hot(d, dim, dtype=pos0.dtype)
        idx = jnp.arange(n)

        def u_ts(r2, eps, sig):
            """Truncated-shifted LJ on squared distance (no cutoff gate —
            callers only evaluate inside the relevant branch)."""
            y = (sig * sig / jnp.maximum(r2, 1e-12)) ** 3
            return 4.0 * eps * (y * y - y - c0)

        def cond(carry):
            pos, a, budget, ncoll, niter, excess, k = carry
            return (budget > 0.0) & (niter < max_events_per_chain)

        def body(carry):
            pos, a, budget, ncoll, niter, excess, k = carry
            k, kthr = jax.random.split(k)
            mask_a = idx == a
            p = jnp.sum(jnp.where(mask_a[:, None], pos, 0.0), axis=0)
            s_a = jnp.sum(jnp.where(mask_a, state.species, 0)).astype(
                state.species.dtype)
            rel = pos - p
            rel = rel - box * jnp.round(rel / box)     # signed min-image
            along = jnp.dot(rel, shift_v, precision=_HIGHEST)  # no TF32
            r0sq = jnp.sum(rel * rel, axis=-1)
            w2 = jnp.maximum(r0sq - along * along, 0.0)
            r0 = jnp.sqrt(r0sq)
            b = jnp.sqrt(w2)

            eps, sig = params.coeffs(s_a, state.species)
            r_m = (2.0 ** (1.0 / 6.0)) * sig
            rc = params.rcut * sig
            u_of = lambda r: u_ts(r * r, eps, sig)
            u_rm = 4.0 * eps * (-0.25 - c0)            # u_ts at r_m

            approaching = along > 0.0
            # exponential uphill threshold per factor
            u01 = jax.random.uniform(
                kthr, (n,), minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)
            d_e = -jnp.log(u01) / beta

            # approach branch: uphill from a1 = min(r0, r_m) down to b
            a1 = jnp.minimum(r0, r_m)
            u_a1 = jnp.where(r0 < r_m, u_of(r0), u_rm)
            e1_max = jnp.where(approaching & (b < a1),
                               u_of(b) - u_a1, 0.0)
            # recede branch: uphill from a2 = max(b_or_r0, r_m) to cutoff
            rr = jnp.where(approaching, b, r0)
            a2 = jnp.maximum(rr, r_m)
            u_a2 = jnp.where(rr > r_m, u_of(rr), u_rm)
            e2_max = jnp.where(a2 < rc, -u_a2, 0.0)

            in_core = approaching & (d_e < e1_max)
            d_e2 = d_e - jnp.where(approaching, e1_max, 0.0)
            in_outer = jnp.logical_not(in_core) & (d_e2 < e2_max)

            def invert(v, sign):
                # 4 eps (y^2 - y - c0) = v  =>  y^2 - y - (c0 + v/4eps) = 0
                disc = jnp.sqrt(jnp.maximum(
                    1.0 + 4.0 * c0 + v / eps, 0.0))
                y = jnp.maximum((1.0 + sign * disc) / 2.0, 1e-12)
                return sig * y ** (-1.0 / 6.0)

            r_core = invert(u_a1 + d_e, +1.0)
            r_outer = invert(u_a2 + d_e2, -1.0)
            s_core = along - jnp.sqrt(
                jnp.maximum(r_core * r_core - w2, 0.0))
            s_outer = along + jnp.sqrt(
                jnp.maximum(r_outer * r_outer - w2, 0.0))
            s_j = jnp.where(in_core, s_core,
                            jnp.where(in_outer, s_outer, jnp.inf))
            s_j = jnp.where(mask_a, jnp.inf, jnp.maximum(s_j, 0.0))

            s_min = jnp.min(s_j)
            j_star = jnp.min(jnp.where(s_j == s_min, idx, n)).astype(
                jnp.int32)
            limit = jnp.minimum(budget, s_cap)
            hit = s_min < limit
            s = jnp.minimum(s_min, limit)
            new_p = (p + s * shift_v) % box
            pos = jnp.where(mask_a[:, None], new_p, pos)
            a = jnp.where(hit, j_star, a)
            # signed separation along e AT the event (the pair moved s
            # closer by then) — the MKK pressure excess; core events
            # contribute +sqrt(r_ev^2 - w^2), well-escape events the
            # negative root (the attractive pull on the pressure)
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
                           name="LJStraightECMC")
