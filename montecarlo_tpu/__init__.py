"""montecarlo_tpu — a JAX Monte Carlo sampling framework for accelerators.

A from-scratch JAX/XLA rebuild of the capabilities of Arianna.jl
(TheDisorderedOrganization/MonteCarlo): a system-agnostic move/policy protocol,
a Metropolis–Hastings engine over many independent chains, schedulable recorder
algorithms, and policy-guided Monte Carlo (PGMC) that adapts proposal
parameters via policy-gradient optimisers — all expressed as pure, traceable
functions compiled into fused device loops, with the chain axis vmapped and
sharded across device meshes.

Public API mirrors the reference export surface (``src/Arianna.jl:26-37``,
``src/PolicyGuided/PolicyGuided.jl:20-21``).
"""

from .core.moves import Move, MoveDef, Policy, generic_apply, tree_select
from .core.system import SystemDef, stack_chains
from .core.metropolis import (Metropolis, StoreParameters, callback_acceptance,
                              mc_step, mc_sweep)
from .core.algorithms import (Algorithm, DeviceAlgorithm, HostAlgorithm,
                              ObservableRecorder, SimView, Format, TXT, DAT,
                              BIN, StoreCallbacks, StoreTrajectories,
                              load_chain_major_trajectories,
                              StoreLastFrames, StoreBackups, PrintTimeSteps)
from .core.simulation import Simulation, build_schedule, run
from .core.tempering import ReplicaExchange, callback_swap_rate, tile_ladder
from .core.wanglandau import (WangLandau, WangLandauModel, WangLandauRefine,
                              callback_wl_flatness, callback_wl_log_f,
                              wl_callbacks)
from .core.ecmc import EventChain, EventChainModel, ecmc_callbacks
from .utils.observability import ProfilerTrace, Throughput
from .utils import analysis
from . import checkpoint
from . import parallel
from . import policy_guided

__version__ = "0.1.0"

__all__ = [
    "Move", "MoveDef", "Policy", "generic_apply", "tree_select",
    "SystemDef", "stack_chains",
    "Metropolis", "StoreParameters", "callback_acceptance",
    "mc_step", "mc_sweep",
    "Algorithm", "DeviceAlgorithm", "HostAlgorithm", "ObservableRecorder",
    "SimView", "Format", "TXT", "DAT", "BIN",
    "StoreCallbacks", "StoreTrajectories", "load_chain_major_trajectories",
    "StoreLastFrames", "StoreBackups",
    "PrintTimeSteps",
    "Simulation", "build_schedule", "run",
    "ReplicaExchange", "tile_ladder", "callback_swap_rate",
    "WangLandau", "WangLandauModel", "WangLandauRefine",
    "callback_wl_log_f", "callback_wl_flatness", "wl_callbacks",
    "EventChain", "EventChainModel", "ecmc_callbacks",
    "Throughput", "ProfilerTrace", "analysis",
    "checkpoint", "parallel", "policy_guided",
]
