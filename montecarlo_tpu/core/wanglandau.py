"""Wang–Landau flat-histogram sampling — density-of-states estimation.

A capability family beyond the reference engine: Arianna.jl only samples a
*fixed* target density through Metropolis–Hastings (``src/metropolis.jl:176-190``);
Wang–Landau instead performs a random walk in *energy space* with the running
acceptance rule ``min(1, g(E_old)/g(E_new))``, converging the estimate
``log g(E)`` of the density of states itself.  From ``g(E)`` every canonical
expectation at every temperature follows by one reweighting sum — the
flat-histogram complement of the WHAM estimators in ``utils/analysis.py``.

Accelerator design:

- Each chain is an **independent Wang–Landau walker** with its own
  ``log_g``/histogram arrays and modification factor, vmapped over the chain
  axis (so the usual mesh sharding applies unchanged).  Independent walkers
  are the standard parallel-WL scheme; averaging their converged ``log_g``
  estimates reduces the error by 1/sqrt(chains).
- The energy walk runs inside the compiled time loop as a
  :class:`~montecarlo_tpu.core.algorithms.DeviceAlgorithm`
  (``moves_per_step`` proposals per step via ``lax.scan``, rejection as
  ``tree_select`` — no mutate-then-revert).
- The 1/t-style refinement control (flatness check, ``f -> sqrt(f)``-type
  schedule — here the classic halving of ``log f``) is *host-side control
  flow* between compiled segments: :class:`WangLandauRefine` is a
  ``HostAlgorithm`` that applies a single jitted per-chain masked update
  (flat chains halve ``log_f`` and reset their histogram; others continue),
  so the device never sees data-dependent Python branching.

The proposal must be symmetric (uniform single-site flips etc.); the WL
acceptance above assumes q(x→x') = q(x'→x).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from .algorithms import DeviceAlgorithm, HostAlgorithm, SimView, _n_calls
from .moves import tree_select

__all__ = [
    "WangLandauModel",
    "WangLandau",
    "WangLandauRefine",
    "wl_callbacks",
    "callback_wl_log_f",
    "callback_wl_flatness",
    "mean_log_g",
    "reweight",
]


@dataclasses.dataclass(frozen=True)
class WangLandauModel:
    """What a system must supply to run under Wang–Landau.

    Fields
    ------
    n_bins:
        Static number of energy bins.  Unreachable bins are fine — flatness
        is measured over *visited* bins only.
    bin_index:
        ``state -> i32`` current energy-bin index of one chain (typically an
        O(1) read of the cached energy carried in the state pytree).
    propose:
        ``(state, key) -> candidate_state`` symmetric proposal for one chain
        (pure; candidate carries its own updated cached energy).
    """

    n_bins: int
    bin_index: Callable[[Any], Any]
    propose: Callable[[Any, Any], Any]


class WangLandau(DeviceAlgorithm):
    """Vmapped parallel Wang–Landau walkers inside the compiled time loop.

    Device-state slice (all chain-major):

    - ``keys``: per-chain counter-based PRNG streams (fold_in(seed, chain),
      then fold_in(·, t) per step — same convention as ``Metropolis``).
    - ``log_g (chains, n_bins) f32``: running log density-of-states estimate.
    - ``hist (chains, n_bins) i32``: visit histogram since the last refinement.
    - ``visited (chains, n_bins) i32``: cumulative visits (never reset) —
      identifies the reachable energy support for normalisation/reweighting.
    - ``log_f (chains,) f32``: current modification factor (``log_g`` bump per
      visit).  Halved by :class:`WangLandauRefine` when the histogram is flat.
    """

    state_key = "wang_landau"

    def __init__(self, sim, model: WangLandauModel, moves_per_step: int = 1,
                 log_f0: float = 1.0, seed: int = 7, dependencies=(), **_):
        self.model = model
        self.moves_per_step = int(moves_per_step)
        self.log_f0 = float(log_f0)
        self.seed = int(seed)
        self.n_chains = sim.n_chains

    def init_state(self, sim):
        base = jax.random.key(self.seed)
        chain_ids = jnp.arange(self.n_chains, dtype=jnp.uint32)
        keys = jax.vmap(jax.random.fold_in, (None, 0))(base, chain_ids)
        nb = self.model.n_bins
        return {
            "keys": keys,
            "log_g": jnp.zeros((self.n_chains, nb), jnp.float32),
            "hist": jnp.zeros((self.n_chains, nb), jnp.int32),
            "visited": jnp.zeros((self.n_chains, nb), jnp.int32),
            "log_f": jnp.full((self.n_chains,), self.log_f0, jnp.float32),
        }

    def step(self, dstate, t):
        slc = dstate[self.state_key]
        model = self.model
        step_keys = jax.vmap(jax.random.fold_in, (0, None))(
            slc["keys"], t.astype(jnp.uint32))

        def one_chain(st, log_g, hist, visited, log_f, key):
            keys = jax.random.split(key, self.moves_per_step)

            def body(carry, k):
                st, log_g, hist, visited = carry
                k_prop, k_acc = jax.random.split(k)
                cand = model.propose(st, k_prop)
                b0 = model.bin_index(st)
                b1 = model.bin_index(cand)
                # acceptance min(1, g(E0)/g(E1)); proposal assumed symmetric
                log_a = log_g[b0] - log_g[b1]
                u = jax.random.uniform(k_acc, (), jnp.float32,
                                       minval=jnp.finfo(jnp.float32).tiny)
                accept = jnp.log(u) < log_a
                st = tree_select(accept, cand, st)
                b = jnp.where(accept, b1, b0)
                log_g = log_g.at[b].add(log_f)
                hist = hist.at[b].add(1)
                visited = visited.at[b].add(1)
                return (st, log_g, hist, visited), None

            (st, log_g, hist, visited), _ = jax.lax.scan(
                body, (st, log_g, hist, visited), keys)
            return st, log_g, hist, visited

        sys, log_g, hist, visited = jax.vmap(one_chain)(
            dstate["sys"], slc["log_g"], slc["hist"], slc["visited"],
            slc["log_f"], step_keys)
        return {**dstate, "sys": sys,
                self.state_key: {**slc, "log_g": log_g, "hist": hist,
                                 "visited": visited}}

    def write_summary(self, io, scheduler):
        io.write("\tWangLandau\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tEnergy bins: {self.model.n_bins}\n")
        io.write(f"\t\tMoves per simulation step: {self.moves_per_step}\n")
        io.write(f"\t\tInitial log f: {self.log_f0}\n")
        io.write(f"\t\tSeed: {self.seed}\n")


def _flatness(hist):
    """min/mean visit ratio over visited bins; 0 if nothing visited.

    Chain-major input (chains, n_bins) -> (chains,).  Flatness is measured
    over bins visited since the last reset only — unreachable energies (e.g.
    the forbidden E = -2N + 4 level of the periodic Ising lattice) must not
    block refinement.
    """
    h = hist.astype(jnp.float32)
    mask = h > 0
    n_seen = jnp.sum(mask, axis=-1)
    mean = jnp.sum(h, axis=-1) / jnp.maximum(n_seen, 1)
    h_min = jnp.min(jnp.where(mask, h, jnp.inf), axis=-1)
    return jnp.where(n_seen > 0, h_min / jnp.maximum(mean, 1.0), 0.0)


class WangLandauRefine(HostAlgorithm):
    """Scheduled flatness check + modification-factor halving.

    Host-side control flow between compiled segments (the classic WL schedule
    ``f -> f/2`` is inherently data-dependent): reads the walker slice, applies
    one jitted masked per-chain update — chains whose histogram satisfies
    ``min >= flatness * mean`` over visited bins halve ``log_f`` (floored at
    ``log_f_min``) and reset their histogram — and writes the slice back.

    Construct with ``dependencies=(WangLandau,)`` in the algorithm list
    (resolved by type like the reference's dependency mechanism,
    ``src/simulation.jl:77-81``).
    """

    def __init__(self, sim, flatness: float = 0.8, log_f_min: float = 1e-6,
                 dependencies=(), **_):
        if not dependencies:
            raise ValueError(
                "WangLandauRefine needs dependencies=(WangLandau,) in the "
                "algorithm list")
        self.walker = dependencies[0]
        self.flatness = float(flatness)
        self.log_f_min = float(log_f_min)

        @jax.jit
        def refine(slc):
            # Right after a histogram reset a walker confined to a few bins
            # would look "flat" over its since-reset support; require the
            # since-reset histogram to cover every bin the walker has ever
            # visited before halving log_f, so log_f cannot crash before the
            # walker re-traverses its full reachable energy range.
            covers = jnp.all((slc["visited"] == 0) | (slc["hist"] > 0),
                             axis=-1)
            flat = covers & (_flatness(slc["hist"]) >= self.flatness)
            log_f = jnp.where(flat, jnp.maximum(slc["log_f"] * 0.5,
                                                self.log_f_min),
                              slc["log_f"])
            hist = jnp.where(flat[:, None], 0, slc["hist"])
            return {**slc, "log_f": log_f, "hist": hist}

        self._refine = refine

    def make_step(self, sim, t):
        key = self.walker.state_key
        slc = sim.device_state[key]
        sim.device_state = {**sim.device_state, key: self._refine(slc)}

    def write_summary(self, io, scheduler):
        io.write("\tWangLandauRefine\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tFlatness criterion: {self.flatness}\n")
        io.write(f"\t\tFinal log f floor: {self.log_f_min}\n")


# -- observables ------------------------------------------------------------

def wl_callbacks(state_key: str = "wang_landau"):
    """Callback factories bound to a walker's device-state key.

    ``Simulation`` uniquifies duplicate state keys (a second WangLandau
    instance becomes ``wang_landau_1``); pass that key here to observe a
    specific walker instead of relying on the default single-instance key.
    Returns ``(callback_log_f, callback_flatness)``.
    """
    suffix = "wl" if state_key == "wang_landau" else state_key

    def log_f(view: SimView):
        return jnp.mean(view.state[state_key]["log_f"])

    def flatness(view: SimView):
        return jnp.mean(_flatness(view.state[state_key]["hist"]))

    log_f.__name__ = f"callback_{suffix}_log_f"
    log_f.__doc__ = "Mean modification factor over walkers."
    flatness.__name__ = f"callback_{suffix}_flatness"
    flatness.__doc__ = "Mean histogram flatness over walkers."
    return log_f, flatness


#: single-instance conveniences (state key ``wang_landau``)
callback_wl_log_f, callback_wl_flatness = wl_callbacks()


# -- estimators -------------------------------------------------------------

def mean_log_g(slc, anchor_bin: int, anchor_log_g: float = 0.0):
    """Average the per-walker ``log_g`` estimates into one, anchored.

    WL determines ``log g`` only up to an additive constant; each walker is
    shifted so ``log_g[anchor_bin] == anchor_log_g`` (e.g. the Ising ground
    level has exactly 2 states: anchor_log_g = log 2), then averaged over
    walkers.  A walker that never visited the anchor bin has no meaningful
    shift (its anchor entry is the untouched initial 0), so it is excluded
    from the average entirely; if no walker reached the anchor the estimate
    is undefined and a ``ValueError`` is raised.  Bins never visited by any
    anchored walker are returned as ``-inf``.

    Returns ``(log_g (n_bins,), support (n_bins,) bool)`` as numpy arrays.
    """
    log_g = np.asarray(slc["log_g"], np.float64)
    visited = np.asarray(slc["visited"]) > 0
    anchored = visited[:, anchor_bin]
    if not anchored.any():
        raise ValueError(
            f"no walker visited anchor bin {anchor_bin}; run longer or pick "
            "an anchor inside the sampled energy range")
    shifted = log_g - log_g[:, anchor_bin:anchor_bin + 1] + anchor_log_g
    w = (visited & anchored[:, None]).astype(np.float64)
    support = w.any(axis=0)
    avg = (shifted * w).sum(axis=0) / np.maximum(w.sum(axis=0), 1.0)
    return np.where(support, avg, -np.inf), support


def reweight(log_g, energies, beta):
    """Canonical moments at inverse temperature ``beta`` from ``log g(E)``.

    ``log_g`` may contain ``-inf`` for unsupported bins (as produced by
    :func:`mean_log_g`).  Returns ``(log_Z, mean_E, var_E)`` — from which
    e.g. the specific heat is ``beta**2 * var_E``.
    """
    log_g = np.asarray(log_g, np.float64)
    energies = np.asarray(energies, np.float64)
    logw = log_g - beta * energies
    m = logw.max()
    w = np.exp(logw - m)
    z = w.sum()
    mean_e = float((w * energies).sum() / z)
    var_e = float((w * (energies - mean_e) ** 2).sum() / z)
    return float(m + np.log(z)), mean_e, var_e
