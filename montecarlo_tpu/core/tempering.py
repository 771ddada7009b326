"""Replica exchange (parallel tempering) over the chain axis.

A capability beyond the reference (Arianna.jl has no replica exchange; its
chains never interact — ``src/metropolis.jl:302-309`` maps them independently).
On an accelerator the chain axis is a sharded array axis, which makes replica
exchange nearly free: a neighbour swap is a gather by a precomputed
permutation, and under a mesh XLA lowers it to collective-permute traffic.

Layout contract: chains are **ladder-major** — chain ``c`` is replica
``c % n_temps`` of ladder ``c // n_temps`` — and each replica owns a fixed
ensemble (its ``beta`` et al.).  A swap exchanges *configurations* between
neighbouring replicas of the same ladder, never the ensemble fields, so every
recorder keeps observing a fixed-temperature chain (the standard
"temperature stays, walker moves" convention).

Acceptance: for neighbours (i, j), with ``lt`` the system's unnormalised log
target,

    log alpha = lt(beta_i, x_j) + lt(beta_j, x_i) - lt(beta_i, x_i) - lt(beta_j, x_j)

evaluated through ``SystemDef.log_target`` on hybrid states (own ensemble,
partner configuration) — with cached energies in the state pytree this is
O(1) per chain, no energy recomputation.  Even/odd neighbour pairings
alternate by step parity (the deterministic-even-odd scheme, which mixes
faster than random pairing).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .algorithms import DeviceAlgorithm, SimView
from .moves import tree_select

__all__ = ["ReplicaExchange", "tile_ladder", "callback_swap_rate"]


def tile_ladder(values: Sequence[float], n_ladders: int,
                dtype=jnp.float32) -> jax.Array:
    """Per-chain ensemble values for ``n_ladders`` copies of a temperature
    ladder, in the ladder-major layout :class:`ReplicaExchange` expects:
    ``out[c] = values[c % len(values)]``."""
    return jnp.tile(jnp.asarray(values, dtype), n_ladders)


def _replace_fields(dst, src, names):
    """Return ``dst`` with the named top-level fields taken from ``src``
    (dataclass states via ``dataclasses.replace``, dict states via merge)."""
    if dataclasses.is_dataclass(dst):
        return dataclasses.replace(
            dst, **{n: getattr(src, n) for n in names})
    if isinstance(dst, dict):
        return {**dst, **{n: src[n] for n in names}}
    raise TypeError(
        "ReplicaExchange needs a dataclass or dict chain state to isolate "
        f"ensemble fields; got {type(dst).__name__}")


class ReplicaExchange(DeviceAlgorithm):
    """Even/odd neighbour swaps between replicas of each temperature ladder.

    Parameters
    ----------
    n_temps:
        Ladder length T; ``sim.n_chains`` must be a multiple (M = ladders × T,
        ladder-major).
    ensemble_fields:
        Top-level state fields that define a replica's ensemble and must NOT
        travel with the configuration on a swap (default ``("beta",)``).
    seed:
        Swap-decision PRNG stream seed (counter-based fold_in on the step,
        independent of the move streams — same design as ``Metropolis``).

    Device state: ``counters`` of shape ``(n_temps - 1, 2)`` holding
    (accepted, attempted) swaps per neighbouring temperature pair, aggregated
    over ladders — the tempering analogue of the per-move acceptance counters
    (``src/metropolis.jl:145-146``).
    """

    state_key = "replica_exchange"

    def __init__(self, sim, n_temps: int,
                 ensemble_fields: Sequence[str] = ("beta",),
                 seed: int = 7, dependencies=(), **_):
        if sim.system.log_target is None:
            raise ValueError(
                "ReplicaExchange requires SystemDef.log_target")
        if n_temps < 2:
            raise ValueError("n_temps must be >= 2")
        if sim.n_chains % n_temps:
            raise ValueError(
                f"n_chains={sim.n_chains} not a multiple of n_temps={n_temps}")
        self.n_temps = int(n_temps)
        self.ensemble_fields = tuple(ensemble_fields)
        self.seed = int(seed)
        self.n_chains = sim.n_chains
        self.log_target = sim.system.log_target

        idx = np.arange(self.n_chains)
        k = idx % self.n_temps
        perms = []
        for parity in (0, 1):
            partner = idx.copy()
            lo = (k % 2 == parity) & (k + 1 < self.n_temps)
            partner[lo] = idx[lo] + 1
            hi = (k >= 1) & ((k - 1) % 2 == parity)
            partner[hi] = idx[hi] - 1
            perms.append(partner)
        self._perms = jnp.asarray(np.stack(perms))  # (2, M)

    def init_state(self, sim):
        return {
            "key": jax.random.key(self.seed),
            "calls": jnp.zeros((), jnp.int32),
            "counters": jnp.zeros((self.n_temps - 1, 2), jnp.int32),
        }

    def step(self, dstate, t):
        slc = dstate[self.state_key]
        state = dstate["sys"]
        # parity from the algorithm's own call counter, not t: a strided
        # scheduler (e.g. swap every 2 steps) must still alternate pairings,
        # or half the ladder's links would never be attempted
        partner = self._perms[slc["calls"] % 2]
        idx = jnp.arange(self.n_chains)
        active = partner != idx

        # hybrid = partner's configuration under my ensemble
        swapped = jax.tree_util.tree_map(lambda x: x[partner], state)
        hybrid = _replace_fields(swapped, state, self.ensemble_fields)

        lt_self = jax.vmap(self.log_target)(state)
        lt_hyb = jax.vmap(self.log_target)(hybrid)
        dlog = lt_hyb + lt_hyb[partner] - lt_self - lt_self[partner]

        # one shared decision per pair: both members read the uniform drawn
        # at the pair's low index
        pair_lo = jnp.minimum(idx, partner)
        u = jax.random.uniform(
            jax.random.fold_in(slc["key"], t.astype(jnp.uint32)),
            (self.n_chains,), jnp.float32)[pair_lo]
        accept = active & (jnp.log(u) < dlog)

        new_sys = tree_select(accept, hybrid, state)

        is_lo = partner > idx           # count each pair once
        pair_id = pair_lo % self.n_temps  # in [0, n_temps - 2] when is_lo
        inc = jnp.stack([(accept & is_lo).astype(jnp.int32),
                         is_lo.astype(jnp.int32)], axis=-1)
        counters = slc["counters"].at[pair_id].add(
            jnp.where(is_lo[:, None], inc, 0))
        return {**dstate, "sys": new_sys,
                self.state_key: {**slc, "calls": slc["calls"] + 1,
                                 "counters": counters}}

    def write_summary(self, io, scheduler):
        from .algorithms import _n_calls
        io.write("\tReplicaExchange\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tLadder length: {self.n_temps}\n")
        io.write(f"\t\tLadders: {self.n_chains // self.n_temps}\n")
        io.write(f"\t\tEnsemble fields: {list(self.ensemble_fields)}\n")
        io.write(f"\t\tSeed: {self.seed}\n")


def callback_swap_rate(view: SimView):
    """Mean swap acceptance over all neighbouring temperature pairs."""
    counters = view.state["replica_exchange"]["counters"]
    acc = counters[..., 0].astype(jnp.float32)
    tot = counters[..., 1].astype(jnp.float32)
    return jnp.sum(acc) / jnp.maximum(jnp.sum(tot), 1.0)
