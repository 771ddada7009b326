"""Move / Policy protocol — the user-extension surface of the framework.

Functional redesign of the reference protocol (Arianna.jl
``src/metropolis.jl:1-162``): instead of abstract types with mutating generic
functions (``sample_action!``, ``perform_action!``, ``invert_action!``,
``perform_action_cached!``, ``log_proposal_density``), a move is a bundle of
*pure, traceable* functions operating on immutable pytree state.  Rejection is
a ``jnp.where``-select over the state pytree rather than a mutate-then-revert,
and the reference's cached-energy trick (``perform_action_cached!``,
``src/metropolis.jl:119``) becomes "carry the cached energy inside the state
pytree" so delta-energies never recompute the full target density.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

__all__ = [
    "Policy",
    "MoveDef",
    "Move",
    "tree_select",
    "generic_apply",
]


def tree_select(pred, on_true, on_false):
    """Elementwise pytree select: the pure-functional accept/reject.

    Replaces the reference's accept-or-revert branch
    (``src/metropolis.jl:184-188``) — under ``vmap`` the predicate is a vector
    over chains, so this compiles to a fused masked update rather than a
    branch.
    """
    return jax.tree_util.tree_map(
        lambda a, b: jnp.where(_expand(pred, a), a, b), on_true, on_false
    )


def _expand(pred, leaf):
    leaf = jnp.asarray(leaf)
    p = jnp.asarray(pred)
    extra = leaf.ndim - p.ndim
    if extra > 0:
        p = p.reshape(p.shape + (1,) * extra)
    return p


class Policy:
    """Proposal distribution over actions (ref ``Policy``, ``src/metropolis.jl:25``).

    Concrete policies implement two pure functions:

    - ``sample(params, key, state) -> action``: draw an action pytree
      (ref ``sample_action!``, ``src/metropolis.jl:49``).
    - ``log_density(params, action, state) -> f32``: log proposal density
      (ref ``log_proposal_density``, ``src/metropolis.jl:62``).

    ``params`` is a pytree of arrays (traced; shared/replicated across chains
    like the aliased parameter arrays of ``src/metropolis.jl:252-260``).
    """

    def sample(self, params, key, state):
        raise NotImplementedError(
            f"No sample is defined for {type(self).__name__}"
        )

    def log_density(self, params, action, state):
        raise NotImplementedError(
            f"No log_density is defined for {type(self).__name__}"
        )


@dataclasses.dataclass(frozen=True)
class MoveDef:
    """Static definition of a Monte Carlo move type.

    Bundles the action semantics the reference spreads over generic-function
    overloads (``src/metropolis.jl:76-119``):

    - ``apply(state, action) -> (new_state, delta_log_target)``: pure analogue
      of ``perform_action!`` + ``delta_log_target_density``
      (``src/metropolis.jl:76,98``).  Returning the delta directly lets systems
      exploit cached energies for O(1)/O(N) incremental evaluation.
    - ``invert(action, new_state) -> action``: ``invert_action!``
      (``src/metropolis.jl:108``) as a pure function.
    - ``reward(action, new_state) -> f32``: PGMC reward hook
      (ref ``src/PolicyGuided/gradients.jl:20``); optional, only needed for
      policy-guided adaptation.

    Instances must be hashable/static (they parameterise traced code); the
    learnable parameters live in :class:`Move`, not here.
    """

    name: str
    policy: Policy
    apply: Callable[[Any, Any], tuple]
    invert: Callable[[Any, Any], Any]
    reward: Optional[Callable[[Any, Any], Any]] = None
    #: optional structural tag (e.g. "gaussian_displacement_1d") letting the
    #: engine select a fused Pallas fast path for recognised move shapes
    kind: str = ""
    #: auxiliary static payload for fused kernels (e.g. the potential fn)
    aux: Any = None


@dataclasses.dataclass
class Move:
    """A move in a pool: definition + parameters + selection weight.

    Mirrors the reference ``Move`` struct (``src/metropolis.jl:140-147``)
    minus the acceptance counters, which live in device state as arrays (see
    ``core/metropolis.py``) so they survive jit/scan.
    """

    move: MoveDef
    params: Any
    weight: float


def generic_apply(perform: Callable, log_target: Callable) -> Callable:
    """Build a MoveDef.apply from a plain state transform + target density.

    For systems without incremental (cached-energy) evaluation: computes
    ``delta_log_target`` as ``log_target(new) - log_target(old)`` exactly like
    the reference's default ``delta_log_target_density``
    (``src/metropolis.jl:98``).
    """

    def apply(state, action):
        new_state = perform(state, action)
        return new_state, log_target(new_state) - log_target(state)

    return apply
