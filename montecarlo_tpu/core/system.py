"""System protocol — what a user must supply to simulate their model.

Functional analogue of the reference's ``AriannaSystem`` extension protocol
(``src/Arianna.jl:22`` plus the generic I/O hooks ``store_trajectory``
``src/algorithms.jl:186``, ``write_system`` ``src/simulation.jl:118``).  A
system here is a *static descriptor* (:class:`SystemDef`) of pure functions
over an immutable chain-state pytree, with the chain axis handled by ``vmap``
rather than Julia's vector-of-mutable-structs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax

__all__ = ["SystemDef", "stack_chains"]


def _default_format_frame(t: int, frame) -> str:
    return f"{t}, {frame}"


@dataclasses.dataclass(frozen=True)
class SystemDef:
    """Static description of a simulatable system.

    Fields
    ------
    name:
        Human-readable name (used in ``summary.log``, mirroring the
        ``write_system`` hook at ``src/simulation.jl:118``).
    log_target:
        ``state -> f32`` unnormalised log target density for ONE chain
        (ref ``unnormalised_log_target_density``, ``src/metropolis.jl:87``).
        Only needed by generic-apply moves; incremental moves compute deltas
        themselves.
    frame:
        ``state -> pytree`` observable snapshot of one chain used by the
        trajectory/backup recorders (what the reference prints in its
        ``store_trajectory`` overload, ``example/particle_1d/particle_1d.jl:63``).
        Defaults to the identity (full state).
    format_frame:
        ``(t, frame) -> str`` one text line per chain per scheduled time, the
        analogue of ``store_trajectory(io, system, t, fmt)``.
    parse_frame:
        Optional ``line -> frame`` inverse of ``format_frame`` enabling the
        restart-file *loader* the reference lacks (SURVEY §5: backups are
        write-only upstream).
    refresh:
        Optional ``state -> state`` pure revalidation of derived caches for
        ONE chain (e.g. recomputing a particle system's total energy from
        positions).  Incremental float32 ``ΔE`` accumulation drifts over long
        segments (~1e-3 relative per ~10^4 N-body moves); when set, the
        orchestrator applies this at every observation point, bounding cache
        drift to one recorder period.  The generalised answer to the
        reference's ``perform_action_cached!`` cache-consistency contract
        (``src/metropolis.jl:119``).
    """

    name: str
    log_target: Optional[Callable[[Any], Any]] = None
    frame: Callable[[Any], Any] = lambda state: state
    format_frame: Callable[[int, Any], str] = _default_format_frame
    parse_frame: Optional[Callable[[str], Any]] = None
    refresh: Optional[Callable[[Any], Any]] = None


def stack_chains(states: list):
    """Stack a list of single-chain state pytrees into one chain-major pytree.

    The replacement for the reference's ``chains::Vector{S}``
    (``src/simulation.jl:17``): one pytree whose leaves carry a leading chain
    axis, ready for ``vmap``/sharding.
    """
    return jax.tree_util.tree_map(lambda *xs: jax.numpy.stack(xs), *states)
