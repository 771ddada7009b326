"""2-D Ising model on a periodic square lattice.

Second discrete model family (the reference is system-agnostic by design,
``README.md:26-31``; its protocol — a state pytree with cached energy plus
incremental-delta moves — is exercised here on a 2-D lattice).  Two sampling
paths are provided:

- :func:`spin_flip_move` — a single-site Metropolis move through the generic
  :class:`~montecarlo_tpu.core.moves.MoveDef` protocol (O(1) delta-energy via
  the four-neighbour local field), the direct analogue of the reference's
  per-attempt ``mc_step!`` recipe (``src/metropolis.jl:176-190``).
- :class:`CheckerboardMetropolis` — the vectorised whole-lattice sweep: the
  square lattice is bipartite, so all sites of one parity have conditionally
  independent acceptance tests and can be updated simultaneously as one fused
  vector op over the (chains, L, L) array.  One step performs both half-sweeps
  = L² Metropolis attempts per chain per step, with no per-site scan.  This is
  a :class:`~montecarlo_tpu.core.algorithms.DeviceAlgorithm` peer of
  ``Metropolis`` (same 3-hook lifecycle, ``src/algorithms.jl:6-37``), showing
  that the algorithm layer is open to samplers beyond the single-proposal MH
  kernel.

Exact check: for small lattices the Boltzmann expectation is brute-force
enumerable (:func:`exact_moments`), giving a non-statistical ground truth the
tests compare both paths against.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.algorithms import DeviceAlgorithm, SimView
from ..core.moves import Move, MoveDef, Policy
from ..core.system import SystemDef

__all__ = ["Ising2DState", "make_system", "init_chains", "spin_flip_move",
           "CheckerboardMetropolis", "WolffCluster", "wolff_step",
           "SwendsenWang", "swendsen_wang_step",
           "wl_model", "wl_bin_energies", "exact_log_g",
           "exact_moments",
           "callback_energy_per_spin", "callback_magnetisation",
           "callback_checkerboard_acceptance", "callback_mean_cluster_size"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Ising2DState:
    spins: jax.Array   # (L, L) int8 in {-1, +1}
    beta: jax.Array    # ()
    j: jax.Array       # () coupling
    energy: jax.Array  # () cached total energy


def _total_energy(spins, j):
    s = spins.astype(jnp.float32)
    return -j * jnp.sum(s * (jnp.roll(s, 1, axis=0) + jnp.roll(s, 1, axis=1)))


def _neighbour_sum(s):
    """Sum of the four nearest neighbours, periodic boundaries; float32."""
    s = s.astype(jnp.float32)
    return (jnp.roll(s, 1, 0) + jnp.roll(s, -1, 0)
            + jnp.roll(s, 1, 1) + jnp.roll(s, -1, 1))


def make_system() -> SystemDef:
    def log_target(state: Ising2DState):
        return -state.beta * state.energy

    def frame(state: Ising2DState):
        return {"m": jnp.mean(state.spins.astype(jnp.float32)),
                "e": state.energy}

    def format_frame(t, fr):
        return f"{t} {float(fr['m'])!r} {float(fr['e'])!r}"

    return SystemDef(name="Ising2D", log_target=log_target, frame=frame,
                     format_frame=format_frame)


def init_chains(n_chains: int, size: int, beta: float, j: float = 1.0,
                seed: int = 42) -> Ising2DState:
    key = jax.random.key(seed)
    spins = jax.random.bernoulli(key, 0.5, (n_chains, size, size))
    spins = 2 * spins.astype(jnp.int8) - 1
    state = Ising2DState(
        spins=spins,
        beta=jnp.full((n_chains,), beta, jnp.float32),
        j=jnp.full((n_chains,), j, jnp.float32),
        energy=jnp.zeros((n_chains,), jnp.float32),
    )
    energy = jax.vmap(lambda st: _total_energy(st.spins, st.j))(state)
    return dataclasses.replace(state, energy=energy)


# ---------------------------------------------------------------------------
# Path 1: single-site flip through the generic move protocol
# ---------------------------------------------------------------------------

class UniformSiteFlip2D(Policy):
    """Pick a lattice site uniformly; symmetric/self-inverse proposal."""

    def sample(self, params, key, state):
        n = state.spins.shape[0] * state.spins.shape[1]
        return jax.random.randint(key, (), 0, n)

    def log_density(self, params, action, state):
        n = state.spins.shape[0] * state.spins.shape[1]
        return -jnp.log(jnp.asarray(float(n), jnp.float32))


def spin_flip_move(weight: float = 1.0) -> Move:
    def apply(state: Ising2DState, site):
        s = state.spins
        lx, ly = s.shape
        i, k = site // ly, site % ly
        nsum = (s[(i - 1) % lx, k] + s[(i + 1) % lx, k]
                + s[i, (k - 1) % ly] + s[i, (k + 1) % ly]).astype(jnp.float32)
        d_e = 2.0 * state.j * s[i, k].astype(jnp.float32) * nsum
        spins = s.at[i, k].set(-s[i, k])
        new_state = dataclasses.replace(
            state, spins=spins, energy=state.energy + d_e)
        return new_state, -state.beta * d_e

    def invert(site, new_state):
        return site  # self-inverse

    def reward(site, new_state):
        return jnp.asarray(1.0, jnp.float32)

    md = MoveDef(name="SpinFlip2D", policy=UniformSiteFlip2D(), apply=apply,
                 invert=invert, reward=reward, kind="ising2d_spin_flip")
    return Move(move=md, params={"dummy": jnp.zeros(())}, weight=weight)


# ---------------------------------------------------------------------------
# Path 2: checkerboard half-sweeps (whole-lattice vector updates)
# ---------------------------------------------------------------------------

def checkerboard_half_sweep(state: Ising2DState, parity, key):
    """Metropolis-update every site of one sublattice simultaneously.

    Valid because the square lattice is bipartite: conditioned on the other
    sublattice, same-parity sites do not interact, so their L²/2 acceptance
    tests are independent.  Compiles to a handful of fused (L, L) vector ops —
    rolls, one exp, one compare — with no per-site control flow.

    Returns ``(new_state, n_accepted)`` with ``n_accepted`` counting flips on
    this half-sweep (attempts = L²/2).

    Requires even lattice dimensions: with periodic boundaries and an odd L
    the (i+j) % 2 colouring is NOT a proper 2-colouring — wrap-around
    neighbours like (i, 0) and (i, L-1) land on the same sublattice, so
    simultaneous updates of interacting sites would bias the sampled
    distribution and corrupt the cached energy.
    """
    s = state.spins
    lx, ly = s.shape
    if lx % 2 or ly % 2:
        raise ValueError(
            f"checkerboard sweeps need even lattice dimensions, got "
            f"({lx}, {ly}): the parity mask is not a proper 2-colouring of a "
            f"periodic odd lattice (wrap-around neighbours share a parity)")
    ii, kk = jnp.meshgrid(jnp.arange(lx), jnp.arange(ly), indexing="ij")
    mask = ((ii + kk) % 2) == parity
    d_e = 2.0 * state.j * s.astype(jnp.float32) * _neighbour_sum(s)
    u = jax.random.uniform(key, (lx, ly), jnp.float32)
    accept = mask & (jnp.log(u) < -state.beta * d_e)
    spins = jnp.where(accept, -s, s)
    energy = state.energy + jnp.sum(jnp.where(accept, d_e, 0.0))
    new_state = dataclasses.replace(state, spins=spins, energy=energy)
    return new_state, jnp.sum(accept, dtype=jnp.int32)


def checkerboard_sweep(state: Ising2DState, key):
    """One full lattice sweep = black then white half-sweep (L² attempts)."""
    k0, k1 = jax.random.split(key)
    state, a0 = checkerboard_half_sweep(state, 0, k0)
    state, a1 = checkerboard_half_sweep(state, 1, k1)
    return state, a0 + a1


class CheckerboardMetropolis(DeviceAlgorithm):
    """Whole-lattice checkerboard Metropolis driver for 2-D lattice systems.

    The vectorised answer to "sweep the lattice": where the reference would
    issue L² sequential single-site ``mc_step!`` calls per sweep
    (``src/metropolis.jl:203-212``), this updates each sublattice as one fused
    (chains, L, L) vector op — no scan over sites.

    Same per-chain counter-based RNG streams as ``Metropolis``
    (fold_in(seed, chain) then fold_in(·, t)), same acceptance-counter
    device-state layout (counters[chain, 0] = (accepted, attempted)).
    """

    state_key = "checkerboard"

    def __init__(self, sim, sweeps: int = 1, seed: int = 1, dependencies=(),
                 **_):
        self.sweeps = int(sweeps)
        self.seed = int(seed)
        self.n_chains = sim.n_chains
        spins = sim.chains0.spins
        self.lattice_shape = tuple(int(d) for d in spins.shape[1:])
        if any(d % 2 for d in self.lattice_shape):
            raise ValueError(
                f"{type(self).__name__} needs even lattice dimensions, got "
                f"{self.lattice_shape}: on a periodic odd lattice the parity "
                f"mask is not a proper 2-colouring (wrap-around neighbours "
                f"share a parity), which would bias the sampled distribution")

    def init_state(self, sim):
        base = jax.random.key(self.seed)
        chain_ids = jnp.arange(self.n_chains, dtype=jnp.uint32)
        keys = jax.vmap(jax.random.fold_in, (None, 0))(base, chain_ids)
        counters = jnp.zeros((self.n_chains, 1, 2), jnp.int32)
        return {"keys": keys, "counters": counters}

    def step(self, dstate, t):
        slc = dstate[self.state_key]
        step_keys = jax.vmap(jax.random.fold_in, (0, None))(
            slc["keys"], t.astype(jnp.uint32))

        def one_chain(st, key):
            if self.sweeps == 1:
                return checkerboard_sweep(st, key)
            keys = jax.random.split(key, self.sweeps)

            def body(carry, k):
                st, acc = carry
                st, a = checkerboard_sweep(st, k)
                return (st, acc + a), None

            (st, acc), _ = jax.lax.scan(
                body, (st, jnp.zeros((), jnp.int32)), keys)
            return st, acc

        sys, acc = jax.vmap(one_chain)(dstate["sys"], step_keys)
        attempts = self.sweeps * int(np.prod(self.lattice_shape))
        inc = jnp.stack(
            [acc, jnp.full_like(acc, attempts)], axis=-1)[:, None, :]
        return {**dstate, "sys": sys,
                self.state_key: {**slc, "counters": slc["counters"] + inc}}

    def write_summary(self, io, scheduler):
        from ..core.algorithms import _n_calls
        io.write("\tCheckerboardMetropolis\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tLattice sweeps per simulation step: {self.sweeps}\n")
        io.write(f"\t\tLattice: {self.lattice_shape}\n")
        io.write(f"\t\tSeed: {self.seed}\n")


def callback_checkerboard_acceptance(view: SimView):
    counters = view.state["checkerboard"]["counters"]
    acc = counters[..., 0].astype(jnp.float32)
    tot = counters[..., 1].astype(jnp.float32)
    return jnp.mean(acc / jnp.maximum(tot, 1.0))


# ---------------------------------------------------------------------------
# Path 3: Wolff cluster updates (rejection-free, beats critical slowing down)
# ---------------------------------------------------------------------------

def wolff_step(state: Ising2DState, key):
    """One Wolff cluster flip, formulated as whole-lattice vector ops.

    The reference engine only offers single-proposal Metropolis–Hastings
    (``src/metropolis.jl:176-190``); cluster algorithms are the classic
    "capability a user would reach for next" on lattice models, and they fit
    the same :class:`~montecarlo_tpu.core.algorithms.DeviceAlgorithm` slot.

    Vectorised design — no sequential flood fill over sites:

    1. *Bond percolation*: activate every aligned nearest-neighbour bond
       independently with ``p = 1 - exp(-2 β J)``.  Pre-sampling all ``2 L²``
       bonds at once is distributionally identical to the textbook grow-from-
       seed recursion, because bonds the recursion never examines are
       independent and marginalise out (Swendsen–Wang ↔ Wolff equivalence).
    2. *Connected component*: the cluster is the activated-bond component of a
       uniformly chosen seed site, found by label propagation — each
       ``lax.while_loop`` iteration dilates the cluster mask through active
       bonds with four rolls and converges in O(cluster diameter) fused
       (L, L) vector steps.
    3. *Flip*: the whole cluster flips with probability 1 (rejection-free);
       the cached energy is refreshed with one O(L²) reduction.

    Returns ``(new_state, cluster_size)``.
    """
    from ..ops.cluster import seed_component_mask

    s = state.spins
    lx, ly = s.shape
    k_seed, k_right, k_down = jax.random.split(key, 3)

    p_bond = 1.0 - jnp.exp(-2.0 * state.beta * state.j)
    aligned_right = s == jnp.roll(s, -1, axis=1)   # bond (i,j)-(i,j+1)
    aligned_down = s == jnp.roll(s, -1, axis=0)    # bond (i,j)-(i+1,j)
    act_right = aligned_right & (
        jax.random.uniform(k_right, (lx, ly)) < p_bond)
    act_down = aligned_down & (
        jax.random.uniform(k_down, (lx, ly)) < p_bond)

    site = jax.random.randint(k_seed, (), 0, lx * ly)
    mask = seed_component_mask(act_right, act_down, site)

    spins = jnp.where(mask, -s, s)
    energy = _total_energy(spins, state.j)
    new_state = dataclasses.replace(state, spins=spins, energy=energy)
    return new_state, jnp.sum(mask, dtype=jnp.int32)


class WolffCluster(DeviceAlgorithm):
    """Wolff cluster driver for the 2-D Ising family.

    Same lifecycle/device-state contract as ``Metropolis`` and
    :class:`CheckerboardMetropolis`: per-chain counter-based RNG streams
    (fold_in(seed, chain) then fold_in(·, t)), a counters slice —
    ``counters[chain, 0] = (total cluster size, clusters flipped)`` — and the
    chain axis handled by ``vmap`` so mesh sharding applies unchanged.

    ``clusters`` = cluster flips per simulation step (ref ``sweepstep``,
    ``src/metropolis.jl:234``).
    """

    state_key = "wolff"

    def __init__(self, sim, clusters: int = 1, seed: int = 1,
                 dependencies=(), **_):
        self.clusters = int(clusters)
        self.seed = int(seed)
        self.n_chains = sim.n_chains
        spins = sim.chains0.spins
        self.lattice_shape = tuple(int(d) for d in spins.shape[1:])
        # The Wolff bond probability p = 1 - exp(-2 beta J) is derived for
        # the ferromagnetic model; with J <= 0 no bonds ever activate and the
        # sampler silently degenerates to flipping the seed spin with
        # probability 1, violating detailed balance.
        j = np.asarray(sim.chains0.j)
        if not np.all(j > 0):
            raise ValueError(
                f"WolffCluster requires a ferromagnetic coupling J > 0 on "
                f"every chain (got min J = {j.min()}); the bond probability "
                f"1 - exp(-2 beta J) is only a valid cluster rule for J > 0")

    def init_state(self, sim):
        base = jax.random.key(self.seed)
        chain_ids = jnp.arange(self.n_chains, dtype=jnp.uint32)
        keys = jax.vmap(jax.random.fold_in, (None, 0))(base, chain_ids)
        counters = jnp.zeros((self.n_chains, 1, 2), jnp.int32)
        return {"keys": keys, "counters": counters}

    def step(self, dstate, t):
        slc = dstate[self.state_key]
        step_keys = jax.vmap(jax.random.fold_in, (0, None))(
            slc["keys"], t.astype(jnp.uint32))

        def one_chain(st, key):
            keys = jax.random.split(key, self.clusters)

            def body(carry, k):
                st, size = carry
                st, n = wolff_step(st, k)
                return (st, size + n), None

            (st, size), _ = jax.lax.scan(
                body, (st, jnp.zeros((), jnp.int32)), keys)
            return st, size

        sys, size = jax.vmap(one_chain)(dstate["sys"], step_keys)
        inc = jnp.stack(
            [size, jnp.full_like(size, self.clusters)], axis=-1)[:, None, :]
        return {**dstate, "sys": sys,
                self.state_key: {**slc, "counters": slc["counters"] + inc}}

    def write_summary(self, io, scheduler):
        from ..core.algorithms import _n_calls
        io.write("\tWolffCluster\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tCluster flips per simulation step: {self.clusters}\n")
        io.write(f"\t\tLattice: {self.lattice_shape}\n")
        io.write(f"\t\tSeed: {self.seed}\n")


def callback_mean_cluster_size(view: SimView):
    counters = view.state["wolff"]["counters"]
    tot = counters[..., 0].astype(jnp.float32)
    n = counters[..., 1].astype(jnp.float32)
    return jnp.mean(tot / jnp.maximum(n, 1.0))


# ---------------------------------------------------------------------------
# Path 4: Swendsen–Wang (whole-lattice Fortuin–Kasteleyn cluster updates)
# ---------------------------------------------------------------------------

def swendsen_wang_step(state: Ising2DState, key):
    """One Swendsen–Wang sweep: decompose the WHOLE lattice into
    Fortuin–Kasteleyn clusters and resample every cluster's spin at once.

    Where :func:`wolff_step` grows one cluster from a seed, Swendsen–Wang
    activates every aligned bond with ``p = 1 - exp(-2 beta J)``, labels all
    activated-bond components in one shot
    (:func:`~montecarlo_tpu.ops.cluster.component_labels` — min-label
    propagation with pointer jumping, O(log L) fused (L, L) vector sweeps),
    and assigns each component a fresh uniform spin by indexing a per-site
    random array with the component id.  Rejection-free, updates all L² sites
    per step, and — unlike the checkerboard sweep — valid on odd lattices
    (no 2-colouring involved).

    Returns ``(new_state, n_clusters)``.
    """
    s = state.spins
    lx, ly = s.shape
    k_right, k_down, k_spin = jax.random.split(key, 3)

    p_bond = 1.0 - jnp.exp(-2.0 * state.beta * state.j)
    act_right = (s == jnp.roll(s, -1, axis=1)) & (
        jax.random.uniform(k_right, (lx, ly)) < p_bond)
    act_down = (s == jnp.roll(s, -1, axis=0)) & (
        jax.random.uniform(k_down, (lx, ly)) < p_bond)

    from ..ops.cluster import component_labels
    labels = component_labels(act_right, act_down)

    # one independent ±1 per potential cluster id = per site; a cluster reads
    # the draw of its canonical (minimum-index) site
    fresh = 2 * jax.random.bernoulli(
        k_spin, 0.5, (lx * ly,)).astype(s.dtype) - 1
    spins = fresh[labels.reshape(-1)].reshape(lx, ly)

    energy = _total_energy(spins, state.j)
    new_state = dataclasses.replace(state, spins=spins, energy=energy)
    # number of clusters = number of sites that are their own canonical label
    own = jnp.arange(lx * ly, dtype=jnp.int32).reshape(lx, ly)
    n_clusters = jnp.sum((labels == own).astype(jnp.int32))
    return new_state, n_clusters


class SwendsenWang(DeviceAlgorithm):
    """Swendsen–Wang driver for the 2-D Ising family.

    Same lifecycle/device-state contract as the other lattice drivers:
    counter-based per-chain RNG streams and a counters slice —
    ``counters[chain, 0] = (total clusters resampled, sweeps)``.

    Like :class:`WolffCluster` this requires ferromagnetic J > 0 (the FK bond
    probability ``1 - exp(-2 beta J)`` is only a valid coupling for J > 0).
    """

    state_key = "swendsen_wang"

    def __init__(self, sim, sweeps: int = 1, seed: int = 1,
                 dependencies=(), **_):
        self.sweeps = int(sweeps)
        self.seed = int(seed)
        self.n_chains = sim.n_chains
        spins = sim.chains0.spins
        self.lattice_shape = tuple(int(d) for d in spins.shape[1:])
        j = np.asarray(sim.chains0.j)
        if not np.all(j > 0):
            raise ValueError(
                f"SwendsenWang requires a ferromagnetic coupling J > 0 on "
                f"every chain (got min J = {j.min()}); the FK bond "
                f"probability 1 - exp(-2 beta J) is only valid for J > 0")

    def init_state(self, sim):
        base = jax.random.key(self.seed)
        chain_ids = jnp.arange(self.n_chains, dtype=jnp.uint32)
        keys = jax.vmap(jax.random.fold_in, (None, 0))(base, chain_ids)
        counters = jnp.zeros((self.n_chains, 1, 2), jnp.int32)
        return {"keys": keys, "counters": counters}

    def step(self, dstate, t):
        slc = dstate[self.state_key]
        step_keys = jax.vmap(jax.random.fold_in, (0, None))(
            slc["keys"], t.astype(jnp.uint32))

        def one_chain(st, key):
            keys = jax.random.split(key, self.sweeps)

            def body(carry, k):
                st, nc = carry
                st, n = swendsen_wang_step(st, k)
                return (st, nc + n), None

            (st, nc), _ = jax.lax.scan(
                body, (st, jnp.zeros((), jnp.int32)), keys)
            return st, nc

        sys, nc = jax.vmap(one_chain)(dstate["sys"], step_keys)
        inc = jnp.stack(
            [nc, jnp.full_like(nc, self.sweeps)], axis=-1)[:, None, :]
        return {**dstate, "sys": sys,
                self.state_key: {**slc, "counters": slc["counters"] + inc}}

    def write_summary(self, io, scheduler):
        from ..core.algorithms import _n_calls
        io.write("\tSwendsenWang\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tLattice sweeps per simulation step: {self.sweeps}\n")
        io.write(f"\t\tLattice: {self.lattice_shape}\n")
        io.write(f"\t\tSeed: {self.seed}\n")


# ---------------------------------------------------------------------------
# Path 5: Wang–Landau binding (density-of-states random walk)
# ---------------------------------------------------------------------------

def wl_model(size: int, j: float = 1.0):
    """Wang–Landau model descriptor for the L×L periodic Ising lattice.

    Energy levels are ``E = -2 N j + 4 j k`` for bin index ``k in [0, N]``
    (N = L²; k = 1 and k = N-1 are unreachable on the periodic lattice —
    flatness is measured over visited bins only, see
    :class:`~montecarlo_tpu.core.wanglandau.WangLandau`).  The proposal is a
    uniform single-site flip (symmetric, as WL requires), with the cached
    energy updated from the O(1) local field exactly as in
    :func:`spin_flip_move`.
    """
    from ..core.wanglandau import WangLandauModel

    n = size * size

    def bin_index(state: Ising2DState):
        return jnp.round(
            (state.energy + 2.0 * n * state.j) / (4.0 * state.j)
        ).astype(jnp.int32)

    def propose(state: Ising2DState, key):
        s = state.spins
        lx, ly = s.shape
        site = jax.random.randint(key, (), 0, n)
        i, k = site // ly, site % ly
        nsum = (s[(i - 1) % lx, k] + s[(i + 1) % lx, k]
                + s[i, (k - 1) % ly] + s[i, (k + 1) % ly]).astype(jnp.float32)
        d_e = 2.0 * state.j * s[i, k].astype(jnp.float32) * nsum
        return dataclasses.replace(
            state, spins=s.at[i, k].set(-s[i, k]), energy=state.energy + d_e)

    return WangLandauModel(n_bins=n + 1, bin_index=bin_index, propose=propose)


def wl_bin_energies(size: int, j: float = 1.0) -> np.ndarray:
    """Energy of each Wang–Landau bin: ``-2 N j + 4 j k``, k = 0..N."""
    n = size * size
    return -2.0 * n * j + 4.0 * j * np.arange(n + 1, dtype=np.float64)


def exact_log_g(size: int, j: float = 1.0) -> np.ndarray:
    """Exact ``log g(E)`` per Wang–Landau bin by enumeration (L*L <= 20).

    Unreachable bins are ``-inf`` — the ground truth for the Wang–Landau
    tests, on the same bin grid as :func:`wl_bin_energies`.
    """
    n = size * size
    if n > 20:
        raise ValueError("exact enumeration is only feasible for L*L <= 20")
    bits = (np.arange(1 << n, dtype=np.int64)[:, None]
            >> np.arange(n)) & 1
    s = (2 * bits - 1).astype(np.float32).reshape(-1, size, size)
    e = -j * np.sum(
        s * (np.roll(s, 1, axis=1) + np.roll(s, 1, axis=2)), axis=(1, 2))
    bins = np.round((e + 2.0 * n * j) / (4.0 * j)).astype(np.int64)
    counts = np.bincount(bins, minlength=n + 1).astype(np.float64)
    with np.errstate(divide="ignore"):
        return np.log(counts)


# ---------------------------------------------------------------------------
# Observables + exact ground truth
# ---------------------------------------------------------------------------

def callback_energy_per_spin(view):
    n = view.sys.spins.shape[-1] * view.sys.spins.shape[-2]
    return jnp.mean(view.sys.energy) / n

def callback_magnetisation(view):
    return jnp.mean(jnp.abs(jnp.mean(
        view.sys.spins.astype(jnp.float32), axis=(-2, -1))))


def exact_moments(size: int, beta: float, j: float = 1.0):
    """Brute-force Boltzmann expectations on an L×L periodic lattice.

    Enumerates all 2^(L²) configurations (feasible for L ≤ 4), returning
    ``(energy per spin, mean |magnetisation|)`` — an exact, non-statistical
    reference for the sampler tests (the 2-D analogue of the 1-D ring's
    transfer-matrix check in ``models/ising.py``).
    """
    n = size * size
    if n > 20:
        raise ValueError("exact enumeration is only feasible for L*L <= 20")
    bits = (np.arange(1 << n, dtype=np.int64)[:, None]
            >> np.arange(n)) & 1                        # (2^n, n)
    s = (2 * bits - 1).astype(np.float32).reshape(-1, size, size)
    e = -j * np.sum(
        s * (np.roll(s, 1, axis=1) + np.roll(s, 1, axis=2)), axis=(1, 2))
    w = np.exp(-beta * (e - e.min()))
    z = w.sum()
    e_spin = float((w * e).sum() / z / n)
    m_abs = float((w * np.abs(s.mean(axis=(1, 2)))).sum() / z)
    return e_spin, m_abs
