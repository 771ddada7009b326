"""Transverse-field Ising model — path-integral (quantum) Monte Carlo.

A capability class beyond the reference engine: quantum statistical
mechanics.  The 1-D transverse-field Ising chain

    H = -J sum_i sigma^z_i sigma^z_{i+1} - h sum_i sigma^x_i     (periodic)

at inverse temperature beta maps, via the Suzuki-Trotter decomposition with
``M`` imaginary-time slices, onto a classical anisotropic Ising model on an
(N, M) space-time torus with couplings

    K_x   = (beta/M) J                     (spatial, within a slice)
    K_tau = -1/2 ln tanh((beta/M) h)       (temporal, between slices)

and weight ``exp(sum K_x s s + sum K_tau s s)``.  Sampling that classical
lattice with any sampler in this framework yields quantum thermal
expectations up to O((beta/M)^2) Trotter error:

- equal-time ⟨sigma^z_i sigma^z_j⟩  = same-slice classical correlation;
- ⟨sigma^x⟩ from temporal-bond statistics (tanh/coth estimator — the
  h-derivative of the bond transfer element);

The sampler here is the whole-lattice checkerboard driver (the (i+m)-parity
2-colouring of the space-time torus), one fused (chains, N, M) vector op per
half-sweep — the same pattern as ``ising2d.CheckerboardMetropolis``.
Exact-diagonalization ground truth for small N ships in
:func:`ed_observables`.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.algorithms import DeviceAlgorithm, SimView, _n_calls
from ..core.system import SystemDef

__all__ = [
    "TFIMState",
    "couplings",
    "make_system",
    "init_chains",
    "TFIMCheckerboard",
    "callback_sz2",
    "callback_szsz",
    "make_sx_callback",
    "ed_observables",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TFIMState:
    """Single-chain space-time configuration."""
    spins: jax.Array   # (N, M) int8 in {-1, +1}; axis 0 space, axis 1 time
    kx: jax.Array      # () spatial coupling  (beta J / M)
    ktau: jax.Array    # () temporal coupling (-1/2 ln tanh(beta h / M))
    energy: jax.Array  # () cached classical action energy (-log weight)


def couplings(beta: float, j: float, h: float, m_slices: int):
    """(K_x, K_tau) of the Suzuki-Trotter classical lattice."""
    dtau = beta / m_slices
    if not (h > 0):
        raise ValueError("transverse field h must be positive (K_tau "
                         "diverges at h=0; use the classical Ising model)")
    kx = dtau * j
    ktau = -0.5 * np.log(np.tanh(dtau * h))
    return float(kx), float(ktau)


def _action_energy(spins, kx, ktau):
    """E_cl = -sum(K_x s s_x+1) - sum(K_tau s s_tau+1) (periodic)."""
    s = spins.astype(jnp.float32)
    return -(kx * jnp.sum(s * jnp.roll(s, 1, axis=0))
             + ktau * jnp.sum(s * jnp.roll(s, 1, axis=1)))


def make_system() -> SystemDef:
    def log_target(state: TFIMState):
        return -state.energy           # beta_cl = 1, couplings carry beta

    def frame(state: TFIMState):
        # magnetization per slice is the cheap full-trajectory observable
        return jnp.mean(state.spins.astype(jnp.float32))

    def format_frame(t, mz):
        return f"{t} {float(mz)!r}"

    return SystemDef(name="TransverseFieldIsing1D", log_target=log_target,
                     frame=frame, format_frame=format_frame)


def init_chains(n_chains: int, n_sites: int, m_slices: int, beta: float,
                j: float = 1.0, h: float = 1.0, seed: int = 42) -> TFIMState:
    if m_slices % 2 or n_sites % 2:
        raise ValueError("need even n_sites and m_slices (periodic "
                         "checkerboard 2-colouring)")
    kx, ktau = couplings(beta, j, h, m_slices)
    key = jax.random.key(seed)
    spins = jnp.where(
        jax.random.bernoulli(key, 0.5, (n_chains, n_sites, m_slices)),
        jnp.int8(1), jnp.int8(-1))
    st = TFIMState(
        spins=spins,
        kx=jnp.full((n_chains,), kx, jnp.float32),
        ktau=jnp.full((n_chains,), ktau, jnp.float32),
        energy=jnp.zeros((n_chains,), jnp.float32),
    )
    energy = jax.vmap(lambda s: _action_energy(s.spins, s.kx, s.ktau))(st)
    return dataclasses.replace(st, energy=energy)


def _half_sweep(state: TFIMState, parity, key):
    """Metropolis-update every site of one (i+m)-parity sublattice at once."""
    s = state.spins.astype(jnp.float32)
    n, m = s.shape
    nbr = (state.kx * (jnp.roll(s, 1, axis=0) + jnp.roll(s, -1, axis=0))
           + state.ktau * (jnp.roll(s, 1, axis=1) + jnp.roll(s, -1, axis=1)))
    d_logp = -2.0 * s * nbr                      # flip: dlog pi per site
    ii = jax.lax.broadcasted_iota(jnp.int32, (n, m), 0)
    mm = jax.lax.broadcasted_iota(jnp.int32, (n, m), 1)
    mask = ((ii + mm) % 2) == parity
    u = jax.random.uniform(key, (n, m), minval=jnp.finfo(jnp.float32).tiny)
    accept = mask & (jnp.log(u) < d_logp)
    spins = jnp.where(accept, -state.spins, state.spins)
    energy = state.energy - jnp.sum(jnp.where(accept, d_logp, 0.0))
    return (dataclasses.replace(state, spins=spins, energy=energy),
            jnp.sum(accept, dtype=jnp.int32))


def checkerboard_sweep(state: TFIMState, key):
    k0, k1 = jax.random.split(key)
    state, a0 = _half_sweep(state, 0, k0)
    state, a1 = _half_sweep(state, 1, k1)
    return state, a0 + a1


class TFIMCheckerboard(DeviceAlgorithm):
    """Whole-space-time-lattice checkerboard sweeps, vmapped over chains."""

    state_key = "tfim_cb"

    def __init__(self, sim, sweeps: int = 1, seed: int = 1, dependencies=(),
                 **_):
        self.sweeps = int(sweeps)
        self.seed = int(seed)
        self.n_chains = sim.n_chains
        self.lattice_shape = tuple(
            int(d) for d in sim.chains0.spins.shape[1:])

    def init_state(self, sim):
        base = jax.random.fold_in(jax.random.key(self.seed), 0x7F1)
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
        io.write("\tTFIMCheckerboard\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tLattice sweeps per simulation step: {self.sweeps}\n")
        io.write(f"\t\tSpace-time lattice: {self.lattice_shape}\n")
        io.write(f"\t\tSeed: {self.seed}\n")


# -- quantum observables ----------------------------------------------------

def callback_sz2(view: SimView):
    """⟨(M_z/N)²⟩: same-slice squared magnetization, averaged over slices
    and chains (equal-time quantum expectation in the Trotter limit)."""
    s = view.sys.spins.astype(jnp.float32)      # (chains, N, M)
    mz = jnp.mean(s, axis=1)                    # per-slice magnetization
    return jnp.mean(mz * mz)


def callback_szsz(view: SimView):
    """Nearest-neighbour equal-time correlation ⟨sigma^z_i sigma^z_{i+1}⟩."""
    s = view.sys.spins.astype(jnp.float32)
    return jnp.mean(s * jnp.roll(s, 1, axis=1))


def make_sx_callback(beta: float, h: float, m_slices: int):
    """⟨sigma^x⟩ estimator from temporal-bond statistics.

    Each time-bond carries transfer element cosh(dtau h) (equal spins) or
    sinh(dtau h) (flipped); differentiating ln Z in h gives the per-bond
    estimator tanh(dtau h) if equal else coth(dtau h).
    """
    dtau = beta / m_slices
    t_eq = float(np.tanh(dtau * h))
    t_ne = float(1.0 / np.tanh(dtau * h))

    def callback_sx(view: SimView):
        s = view.sys.spins.astype(jnp.float32)
        same = s * jnp.roll(s, 1, axis=2)       # +1 equal, -1 flipped
        est = jnp.where(same > 0, t_eq, t_ne)
        return jnp.mean(est)

    return callback_sx


# -- exact diagonalization ground truth (small N) ---------------------------

def ed_observables(n_sites: int, beta: float, j: float, h: float):
    """Thermal ⟨sigma^x⟩, ⟨sigma^z_i sigma^z_{i+1}⟩, ⟨(M_z/N)²⟩ by exact
    diagonalization (dense 2^N — keep N ≤ 12)."""
    dim = 2 ** n_sites
    sz = np.array([[1.0, 0.0], [0.0, -1.0]])
    sx = np.array([[0.0, 1.0], [1.0, 0.0]])

    def site_op(op, i):
        out = np.eye(1)
        for k in range(n_sites):
            out = np.kron(out, op if k == i else np.eye(2))
        return out

    ham = np.zeros((dim, dim))
    for i in range(n_sites):
        ham -= j * site_op(sz, i) @ site_op(sz, (i + 1) % n_sites)
        ham -= h * site_op(sx, i)
    w, v = np.linalg.eigh(ham)
    w -= w.min()
    boltz = np.exp(-beta * w)
    z = boltz.sum()

    def expval(op):
        return float(np.einsum("ij,ji->", (v * boltz) @ v.T, op) / z)

    ex_sx = np.mean([expval(site_op(sx, i)) for i in range(n_sites)])
    ex_zz = np.mean([expval(site_op(sz, i) @ site_op(sz, (i + 1) % n_sites))
                     for i in range(n_sites)])
    mz = sum(site_op(sz, i) for i in range(n_sites)) / n_sites
    ex_mz2 = expval(mz @ mz)
    return {"sx": float(ex_sx), "szsz": float(ex_zz), "mz2": float(ex_mz2)}
