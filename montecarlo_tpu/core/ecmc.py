"""Event-chain Monte Carlo — rejection-free, non-reversible sampling.

The reference names ECMC as its extensibility target
(``/root/reference/README.md:27`` "advanced techniques like event-chain
Monte Carlo") but does not implement it.  This module adds it as a first-
class :class:`~montecarlo_tpu.core.algorithms.DeviceAlgorithm`: instead of
propose/accept/reject, a *lifted* variable (an active particle plus a
direction) moves deterministically until an **event** — computed in closed
form from an exponential hazard draw or a hard-core collision — transfers the
lifting.  Every move is accepted; irreversibility (the lifted dynamics
breaks detailed balance while preserving the target marginal) shortens
autocorrelation times relative to reversible MH.

Accelerator design: an event is a *fixed-shape* computation (O(1) for the 1-D
zig-zag, one O(N) vector pass for hard-disk collision times), so
``events_per_step`` events run as a ``lax.scan`` inside the compiled time
loop and the chain axis is vmapped/sharded exactly like Metropolis.  No
``while`` loops, no data-dependent shapes: budget exhaustion, lifting
transfer, and chain restarts are all ``where``-selects.

A model plugs in via :class:`EventChainModel` with two pure hooks:

- ``init_lift(state, key) -> lift`` — initial lifting variables for one
  chain (active id, direction, remaining chain budget, ...).
- ``event_step(state, lift, key) -> (state', lift', stats)`` — advance one
  chain by exactly one event and return a pytree of *additive* statistics
  (e.g. elapsed time and time-integrals of observables; ECMC expectations
  are time averages along the trajectory, not sample averages at events).

Concrete instances: ``models.particle1d.zigzag_model`` (closed-form events
for the harmonic target — the 1-D zig-zag process) and
``models.hard_disks`` (straight event chains for hard disks, the original
ECMC application of Bernard, Krauth & Wilson 2009).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp

from .algorithms import DeviceAlgorithm, SimView, _n_calls

__all__ = ["EventChainModel", "EventChain", "ecmc_callbacks"]


@dataclasses.dataclass(frozen=True)
class EventChainModel:
    """Pure hooks a system supplies to run under event-chain MC."""

    init_lift: Callable[[Any, Any], Any]
    event_step: Callable[[Any, Any, Any], Any]
    name: str = "EventChainModel"


class EventChain(DeviceAlgorithm):
    """Vmapped event-chain sampler inside the compiled time loop.

    Device-state slice (chain-major):

    - ``keys``: per-chain counter-based PRNG streams (``fold_in(seed, chain)``
      then ``fold_in(., t)`` per step — the Metropolis convention).
    - ``lift``: per-chain lifting variables (model-defined pytree).
    - ``stats``: per-chain additive statistics accumulated over every event
      (model-defined pytree; zero-initialised from the model's own shapes).
    - ``n_events``: per-chain event counter (i64 would overflow nothing here;
      i32 at 1e9 events is plenty per run).
    """

    state_key = "ecmc"

    def __init__(self, sim, model: EventChainModel,
                 events_per_step: int = 1, seed: int = 13,
                 dependencies=(), **_):
        self.model = model
        self.events_per_step = int(events_per_step)
        self.seed = int(seed)
        self.n_chains = sim.n_chains

    def init_state(self, sim):
        base = jax.random.fold_in(jax.random.key(self.seed), 0x0EC3C)
        chain_ids = jnp.arange(self.n_chains, dtype=jnp.uint32)
        keys = jax.vmap(jax.random.fold_in, (None, 0))(base, chain_ids)
        sys0 = jax.tree_util.tree_map(jnp.asarray, sim.chains0)
        lift = jax.vmap(self.model.init_lift)(
            sys0, jax.vmap(jax.random.fold_in, (0, None))(
                keys, jnp.uint32(0xF117)))
        # zero stats with the model's own shapes (one traced probe)
        one_state = jax.tree_util.tree_map(lambda a: a[0], sys0)
        one_lift = jax.tree_util.tree_map(lambda a: a[0], lift)
        stats_shape = jax.eval_shape(
            self.model.event_step, one_state, one_lift,
            jax.random.key(0))[2]
        stats = jax.tree_util.tree_map(
            lambda s: jnp.zeros((self.n_chains,) + s.shape, s.dtype),
            stats_shape)
        return {"keys": keys, "lift": lift, "stats": stats,
                "n_events": jnp.zeros((self.n_chains,), jnp.int32)}

    def step(self, dstate, t):
        slc = dstate[self.state_key]
        step_keys = jax.vmap(jax.random.fold_in, (0, None))(
            slc["keys"], t.astype(jnp.uint32))

        def one_chain(state, lift, stats, key):
            keys = jax.random.split(key, self.events_per_step)

            def body(carry, k):
                st, lf, acc = carry
                st, lf, inc = self.model.event_step(st, lf, k)
                acc = jax.tree_util.tree_map(lambda a, b: a + b, acc, inc)
                return (st, lf, acc), None

            (state, lift, stats), _ = jax.lax.scan(
                body, (state, lift, stats), keys)
            return state, lift, stats

        sys, lift, stats = jax.vmap(one_chain)(
            dstate["sys"], slc["lift"], slc["stats"], step_keys)
        return {**dstate, "sys": sys,
                self.state_key: {**slc, "lift": lift, "stats": stats,
                                 "n_events": slc["n_events"]
                                 + self.events_per_step}}

    def write_summary(self, io, scheduler):
        io.write("\tEventChain\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tModel: {self.model.name}\n")
        io.write(f"\t\tEvents per simulation step: {self.events_per_step}\n")
        io.write(f"\t\tSeed: {self.seed}\n")


def ecmc_callbacks(state_key: str = "ecmc"):
    """(callback_ecmc_events,) — event count per chain.

    The driver increments every chain's counter by the same
    ``events_per_step``, so the per-chain counts are identical and the mean
    equals the int32 minimum — returned as int32 so the observable stays
    exact up to 2^31 events (a float32 mean silently loses integer precision
    past ~1.7e7 events per chain)."""

    def events(view: SimView):
        return jnp.min(view.state[state_key]["n_events"])

    events.__name__ = f"callback_{state_key}_events"
    return (events,)
