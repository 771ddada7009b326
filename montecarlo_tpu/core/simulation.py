"""Simulation orchestrator.

Rebuild of the reference time loop (``src/simulation.jl``) around XLA's
compilation model.  The reference dispatches ``make_step!`` per algorithm per
timestep from a host loop (``src/simulation.jl:184-191``); doing that on an
accelerator would bottleneck on host↔device latency.  Instead (SURVEY §7.4):

- Device algorithms (Metropolis, PGMC estimator/update) execute inside ONE
  compiled ``lax.fori_loop`` whose body applies each algorithm under a
  ``lax.cond`` on a precomputed boolean schedule mask — arbitrary schedules,
  single compilation.
- Recorder events are "sync points".  Sorted sync times are factored into
  arithmetic runs (:func:`montecarlo_tpu.core.schedule.compress_runs`) and
  each run executes as an on-device scan that advances ``stride`` steps and
  writes observables into a device-resident ring buffer, flushed to host once
  per chunk — the "on-device trajectory buffers" of BASELINE.json.
- Host algorithms and non-bufferable recorders (backups) fall back to
  per-event advance + pull, preserving the reference's in-order-within-a-step
  semantics for the device side.

Algorithm-list construction mirrors the reference's NamedTuple DSL with
dependency resolution by constructor type (``src/simulation.jl:68-88``).
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Any, Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from .algorithms import (Algorithm, DeviceAlgorithm, HostAlgorithm,
                         ObservableRecorder, SimView)
from .schedule import build_schedule, compress_runs
from .system import SystemDef

__all__ = ["Simulation", "run", "build_schedule"]

_CHUNK = 512          # periods buffered on device per flush
_MIN_BUFFERED = 4     # below this run length, per-event path is cheaper


class Simulation:
    """Holds chains + algorithms + schedules; see module docstring.

    Mirrors the reference ``Simulation`` struct and convenience constructor
    (``src/simulation.jl:16-88``).  ``algorithm_list`` entries are dicts with
    an ``algorithm`` class, optional ``scheduler`` (default: every step),
    optional ``dependencies`` (tuple of previously-listed algorithm classes,
    resolved to instances by type matching), plus algorithm kwargs.
    """

    def __init__(self, system: SystemDef, chains, algorithm_list,
                 steps: int, path: str = "data", verbose: bool = False,
                 mesh=None):
        self.system = system
        self.mesh = mesh
        if isinstance(chains, (list,)) and chains:
            # reference-style "vector of systems" input: stack to chain-major
            from .system import stack_chains
            chains = stack_chains(chains)
        self.chains0 = chains
        leaves = jax.tree_util.tree_leaves(chains)
        if not leaves:
            raise ValueError("chains pytree has no leaves")
        self.n_chains = int(leaves[0].shape[0])
        self.steps = int(steps)
        self.path = path
        self.verbose = verbose
        self.t = 0
        self.device_state: Dict[str, Any] = {}

        self.algorithms: List[Algorithm] = []
        self.schedulers: List[np.ndarray] = []
        for spec in algorithm_list:
            spec = dict(spec)
            cls = spec.pop("algorithm")
            sched = spec.pop("scheduler", None)
            if sched is None:
                sched = np.arange(1, self.steps + 1, dtype=np.int64)
            sched = np.asarray(sched, dtype=np.int64)
            if sched.size and (not np.all(np.diff(sched) >= 0)):
                raise ValueError(f"scheduler for {cls.__name__} must be sorted")
            if sched.size and (sched[0] < 0 or sched[-1] > self.steps):
                raise ValueError(
                    f"scheduler for {cls.__name__} out of range [0, steps]")
            deps = self._resolve_deps(spec.pop("dependencies", ()), cls)
            inst = cls(self, dependencies=deps, **spec)
            self.algorithms.append(inst)
            self.schedulers.append(sched)

        # unique state keys for device algorithms (list order preserved)
        seen = set()
        self.device_algos: List[DeviceAlgorithm] = []
        for a in self.algorithms:
            if isinstance(a, DeviceAlgorithm):
                base = a.state_key or type(a).__name__.lower()
                key, i = base, 1
                while key in seen:
                    key = f"{base}_{i}"
                    i += 1
                a.state_key = key
                seen.add(key)
                self.device_algos.append(a)

        # Per-algorithm parameter namespaces: the first params-owning
        # algorithm keeps the canonical "params" slot (SimView.params,
        # reference parity); every further owner — e.g. a second Metropolis
        # with a different pool on its own schedule — gets its own slot so
        # two samplers never index each other's parameter tuples.
        owners = [a for a in self.device_algos if hasattr(a, "init_params")]
        for i, a in enumerate(owners):
            a.params_key = "params" if i == 0 else f"params_{a.state_key}"

        os.makedirs(self.path, exist_ok=True)

    def _resolve_deps(self, dep_spec, cls):
        """Resolve a ``dependencies`` entry to algorithm instances.

        Each item may be a type (matches every previously-listed instance,
        the reference's mechanism — ``src/simulation.jl:77-81``), an integer
        index into the algorithm list so far (disambiguates when e.g. two
        Metropolis instances coexist), or an instance directly.
        """
        deps = []
        for d in dep_spec:
            if isinstance(d, bool):
                raise TypeError(f"invalid dependency spec for "
                                f"{cls.__name__}: {d!r}")
            if isinstance(d, int):
                if not 0 <= d < len(self.algorithms):
                    raise ValueError(
                        f"dependency index {d} for {cls.__name__} is out of "
                        f"range: integer dependencies must point at one of "
                        f"the {len(self.algorithms)} previously listed "
                        f"algorithm(s)")
                deps.append(self.algorithms[d])
            elif isinstance(d, type):
                deps.extend(a for a in self.algorithms if isinstance(a, d))
            elif isinstance(d, Algorithm):
                deps.append(d)
            else:
                raise TypeError(f"invalid dependency spec for "
                                f"{cls.__name__}: {d!r}")
        return tuple(dict.fromkeys(deps))

    # ------------------------------------------------------------------
    def init_device_state(self):
        dstate: Dict[str, Any] = {
            "sys": jax.tree_util.tree_map(jnp.asarray, self.chains0),
            "t": jnp.asarray(0, jnp.int32),
            "params": (),
        }
        for a in self.device_algos:
            if hasattr(a, "init_params"):
                dstate[a.params_key] = a.init_params()
        for a in self.device_algos:
            dstate[a.state_key] = a.init_state(self)
        if self.mesh is not None:
            from ..parallel.mesh import shard_device_state
            dstate = shard_device_state(dstate, self.mesh, self.n_chains)
        return dstate

    def view(self, dstate) -> SimView:
        return SimView(sys=dstate["sys"], params=dstate["params"],
                       t=dstate["t"], state=dstate)

    def run(self):
        run(self)


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

def run(simulation: Simulation):
    """Run the simulation (ref ``run!``, ``src/simulation.jl:175-204``)."""
    sim = simulation
    try:
        if sim.verbose:
            print("\n" + "-" * 50)
            print("\033[1;32mINITIALISATION\033[0m")
        for alg in sim.algorithms:
            alg.initialise(sim)
        resuming = bool(sim.device_state) and sim.t > 0
        if not resuming:
            sim.device_state = sim.init_device_state()
        _write_summary(sim)
        if not resuming:
            _store_first(sim)
        if sim.verbose:
            print("\033[1;32m\nRUNNING SIMULATION...\033[0m")
        t_start = time.perf_counter()
        _execute(sim)
        jax.block_until_ready(sim.device_state)
        for alg in sim.device_algos:
            validate = getattr(alg, "validate_state", None)
            if validate is not None:
                validate(sim.device_state)
        sim_time = time.perf_counter() - t_start
        if sim.verbose:
            print(f"\nSimulation completed in {sim_time} s")
        _update_summary(sim, sim_time)
    finally:
        if sim.verbose:
            print("\033[1;32m\nFINALISATION\033[0m")
        _store_last(sim)
        for alg in sim.algorithms:
            alg.finalise(sim)
        _finalise_summary(sim)
        if sim.verbose:
            print("\033[1;32m\nDONE\033[0m")
            print("-" * 50 + "\n")


def _store_first(sim: Simulation):
    """store_first semantics: observe at t=0 before any step
    (ref ``initialise`` hooks, e.g. ``src/algorithms.jl:90-95``)."""
    recs = [a for a in sim.algorithms
            if isinstance(a, ObservableRecorder) and a.store_first]
    _pull_and_write(sim, recs, 0)


def _store_last(sim: Simulation):
    recs = [a for a in sim.algorithms
            if isinstance(a, ObservableRecorder) and a.store_last]
    if sim.device_state:
        _pull_and_write(sim, recs, sim.t)


def _pull_and_write(sim, recorders, t):
    if not recorders:
        return

    def observe(ds):
        out = tuple(r.observable(sim.view(ds)) for r in recorders)
        if sim.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            out = jax.lax.with_sharding_constraint(
                out, NamedSharding(sim.mesh, PartitionSpec()))
        return out

    values = jax.device_get(jax.jit(observe)(sim.device_state))
    for r, v in zip(recorders, values):
        r.write(sim, t, v)


# -- compiled advance -------------------------------------------------------

def build_chunk_runner(advance, refresh, observe):
    """Buffered runner: ``n_periods`` advances, each followed by an
    on-device observable emit into a CHUNK-deep ring buffer flushed to host
    once per chunk (the "on-device trajectory buffers" of BASELINE.json).

    Module-level so the scaling test can lower the EXACT production chunk
    program over a mesh and assert its collective footprint
    (``tests/test_sharding.py``): the advance inside stays collective-free;
    only the observable emission communicates.
    """

    @jax.jit
    def run_chunk(ds, masks, first_dt, stride, n_periods):
        shapes = jax.eval_shape(observe, ds)
        bufs = jax.tree_util.tree_map(
            lambda s: jnp.zeros((_CHUNK,) + s.shape, s.dtype), shapes)

        def body(i, carry):
            ds, bufs = carry
            dt = jnp.where(i == 0, first_dt, stride)
            ds = refresh(advance(ds, masks, dt))
            obs = observe(ds)
            bufs = jax.tree_util.tree_map(
                lambda b, o: jax.lax.dynamic_update_index_in_dim(
                    b, o, i, 0), bufs, obs)
            return ds, bufs

        return jax.lax.fori_loop(0, n_periods, body, (ds, bufs))

    return run_chunk


def _make_advance(device_algos, always_on=None):
    """Build the fused device time-stepper.

    ``masks`` is a tuple of bool arrays (length steps+1), one per device
    algorithm, indexed by timestep — the compiled replacement for the
    reference's sparse scheduler-counter check (``src/simulation.jl:186``).
    ``always_on[k]`` (static) marks algorithms whose schedule covers every
    step, letting the body skip the ``lax.cond`` for the common case.
    """
    if always_on is None:
        always_on = (False,) * len(device_algos)

    def advance(ds, masks, n_steps):
        def body(_, ds):
            t = ds["t"] + 1
            ds = {**ds, "t": t}
            for alg, mask, always in zip(device_algos, masks, always_on):
                if always:
                    ds = alg.step(ds, ds["t"])
                else:
                    ds = jax.lax.cond(
                        mask[t], lambda d, a=alg: a.step(d, d["t"]),
                        lambda d: d, ds)
            return ds
        return jax.lax.fori_loop(0, n_steps, body, ds)

    return advance


def _warn_rng_impl_discarded(alg):
    if getattr(alg, "rng_impl", None):
        import warnings
        warnings.warn(
            f"Metropolis(rng_impl={alg.rng_impl!r}) requested, but the fused "
            "sweep kernel was auto-selected and draws from its own hashed "
            "counter stream (a different stream family).  Pass fused='off' "
            "to keep the requested streams on the generic path.",
            UserWarning, stacklevel=3)


def _make_hybrid_advance(met, sparse_algos):
    """Fused fast path composed with sparse device algorithms (PGMC).

    Between two consecutive firings of the sparse algorithms (estimator /
    update events, replica exchange) the always-on Metropolis advances
    through its segment fast path; at each event step the sparse algorithms
    run in list order — the reference composes such peers through its
    in-order algorithm list (``src/simulation.jl:185-191``,
    ``src/PolicyGuided/update.jl:50``).

    Requires the Metropolis to be the FIRST device algorithm (within a step
    the fused sweep through t fires before the sparse algorithms at t, which
    is exactly the reference's list-order semantics).
    """

    def advance(ds, masks, n_steps):
        sparse_masks = masks[1:]
        comb = sparse_masks[0]
        for m in sparse_masks[1:]:
            comb = comb | m
        idx = jnp.arange(comb.shape[0], dtype=jnp.int32)
        t_end = ds["t"] + jnp.asarray(n_steps, jnp.int32)

        def cond(ds):
            return ds["t"] < t_end

        def body(ds):
            t = ds["t"]
            big = jnp.iinfo(jnp.int32).max
            cand = jnp.where(comb & (idx > t) & (idx <= t_end), idx, big)
            t_next = jnp.minimum(jnp.min(cand), t_end)
            ds = met.fused_advance(ds, t_next - t)
            for alg, m in zip(sparse_algos, sparse_masks):
                ds = jax.lax.cond(
                    m[ds["t"]], lambda d, a=alg: a.step(d, d["t"]),
                    lambda d: d, ds)
            return ds

        return jax.lax.while_loop(cond, body, ds)

    return advance


def _select_advance(sim: Simulation):
    """Pick the device time-stepper.

    1. Single always-on Metropolis with a fusable pool -> its segment fast
       path (Triton sweep kernel or cell MC) directly.
    2. Always-on fusable Metropolis listed first + sparse further device
       algorithms (the PGMC estimator/update pattern) -> the hybrid stepper:
       fused segments between events, generic steps at events.
    3. Otherwise -> the generic mask-scheduled loop.
    """
    def covers_all(sched):
        return (len(sched) == sim.steps and sched[0] == 1
                and sched[-1] == sim.steps)

    algos = sim.device_algos
    if algos and getattr(algos[0], "supports_fused", False):
        alg = algos[0]
        sched = sim.schedulers[sim.algorithms.index(alg)]
        if covers_all(sched):
            if len(algos) == 1:
                _warn_rng_impl_discarded(alg)

                def advance(ds, masks, n_steps):
                    return alg.fused_advance(
                        ds, jnp.asarray(n_steps, jnp.int32))
                return advance
            # hybrid: worthwhile when the other device algorithms fire on a
            # minority of steps (each event costs a kernel relaunch)
            others = [sim.schedulers[sim.algorithms.index(a)]
                      for a in algos[1:]]
            n_events = len({int(t) for s in others for t in s})
            if n_events * 2 <= sim.steps:
                _warn_rng_impl_discarded(alg)
                return _make_hybrid_advance(alg, algos[1:])
    always_on = tuple(
        covers_all(sim.schedulers[sim.algorithms.index(a)]) for a in algos)
    return _make_advance(algos, always_on)


def _execute(sim: Simulation):
    """Run the time loop, falling back to the generic path (and resuming
    from the last sync point — the offending chunk is discarded before any
    recorder writes) when an auto-selected cell-MC bind overflows."""
    from .metropolis import Metropolis
    while True:
        try:
            return _execute_inner(sim)
        except Metropolis.CellBindInvalid as e:
            import warnings
            e.alg.disable_cell_path()
            # clear any latched flag in the COMMITTED state so a later
            # checkpoint/restore cannot spuriously re-raise (defensive —
            # committed states have always passed check_state)
            slc = sim.device_state.get(e.alg.state_key)
            if isinstance(slc, dict) and "cell_overflow" in slc:
                import jax.numpy as _jnp
                sim.device_state = {
                    **sim.device_state,
                    e.alg.state_key: {**slc,
                                      "cell_overflow": _jnp.zeros((), bool)}}
            warnings.warn(
                "cell-MC bind exceeded the planned cell capacity at "
                f"t={sim.t}; falling back to the generic path for the rest "
                "of the run (raise cell_opts={'cap_slack': ...} to keep "
                "the fast path)", RuntimeWarning, stacklevel=2)


def _execute_inner(sim: Simulation):
    advance = _select_advance(sim)

    # cache revalidation at observation points (SystemDef.refresh): bounds
    # incremental-energy float drift to one recorder period
    if sim.system.refresh is not None:
        _vrefresh = jax.vmap(sim.system.refresh)

        def refresh(ds):
            return {**ds, "sys": _vrefresh(ds["sys"])}
    else:
        refresh = lambda ds: ds

    def advance_r(ds, masks, n_steps):
        return refresh(advance(ds, masks, n_steps))

    advance_j = jax.jit(advance_r)

    def check_state(ds):
        # surface latched device-side failure flags (e.g. an invalid cell
        # bind) at every host sync point — failing within one recorder
        # period instead of at the end of a long run
        for a in sim.device_algos:
            validate = getattr(a, "validate_state", None)
            if validate is not None:
                validate(ds)

    masks = []
    for a in sim.device_algos:
        i = sim.algorithms.index(a)
        m = np.zeros(sim.steps + 1, dtype=bool)
        sched = sim.schedulers[i]
        m[sched[(sched > 0) & (sched <= sim.steps)]] = True
        masks.append(jnp.asarray(m))
    masks = tuple(masks)

    # sync events: (obs recorder indices, host algorithm indices) per time
    events: Dict[int, tuple] = {}
    for i, (alg, sched) in enumerate(zip(sim.algorithms, sim.schedulers)):
        if isinstance(alg, (ObservableRecorder, HostAlgorithm)):
            for t in sched[(sched > 0) & (sched <= sim.steps)]:
                events.setdefault(int(t), ([], []))
                if isinstance(alg, ObservableRecorder):
                    events[int(t)][0].append(i)
                else:
                    events[int(t)][1].append(i)

    # on resume (sim.t > 0 via checkpoint.resume_state) skip past events
    sync_ts = sorted(t for t in events if t > sim.t)
    observe_cache: Dict[tuple, Any] = {}
    chunk_cache: Dict[tuple, Any] = {}

    if sim.mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        repl = NamedSharding(sim.mesh, PartitionSpec())
    else:
        repl = None

    def make_observe(obs_ids):
        if obs_ids not in observe_cache:
            recs = [sim.algorithms[i] for i in obs_ids]

            def observe(ds):
                v = sim.view(ds)
                out = tuple(r.observable(v) for r in recs)
                if repl is not None:
                    # replicate so every process can device_get the values
                    # (multi-host: inserts the all-gather once, on device)
                    out = jax.lax.with_sharding_constraint(out, repl)
                return out

            observe_cache[obs_ids] = (observe, jax.jit(observe))
        return observe_cache[obs_ids]

    def make_chunk(obs_ids):
        if obs_ids not in chunk_cache:
            observe, _ = make_observe(obs_ids)
            chunk_cache[obs_ids] = build_chunk_runner(advance, refresh,
                                                      observe)
        return chunk_cache[obs_ids]

    ds = sim.device_state

    # group sync times into uniform runs (same signature, constant stride)
    groups = _group_events(sync_ts, events)
    for times, obs_ids, host_ids in groups:
        bufferable = (not host_ids
                      and len(times) >= _MIN_BUFFERED
                      and all(getattr(sim.algorithms[i], "buffered_ok", True)
                              for i in obs_ids))
        if bufferable:
            _, stride, _ = compress_runs(np.asarray(times))[0]
            run_chunk = make_chunk(obs_ids)
            recs = [sim.algorithms[i] for i in obs_ids]

            def flush(bufs, ds_after, ts):
                # committing a chunk: state validity first (cheap scalar
                # pull), then the buffer transfer + host writes — by now
                # the NEXT chunk is already dispatched, so the transfer
                # overlaps its device compute (one-deep pipeline)
                check_state(ds_after)
                vals = jax.device_get(bufs)
                for r, v in zip(recs, vals):
                    r.write_batch(sim, ts, jax.tree_util.tree_map(
                        lambda x: x[:len(ts)], v))
                sim.t = int(ts[-1])
                sim.device_state = ds_after

            pos = 0
            t_disp = sim.t          # end time of the last DISPATCHED chunk
            pending = None
            while pos < len(times):
                n = min(_CHUNK, len(times) - pos)
                first_dt = times[pos] - t_disp
                ds, bufs = run_chunk(ds, masks, first_dt,
                                     stride if stride else 1, n)
                t_disp = times[pos + n - 1]
                if pending is not None:
                    flush(*pending)
                pending = (bufs, ds, times[pos:pos + n])
                pos += n
            if pending is not None:
                flush(*pending)
        else:
            _, observe_j = make_observe(obs_ids) if obs_ids else (None, None)
            for t in times:
                if t > sim.t:
                    ds = advance_j(ds, masks, t - sim.t)
                    check_state(ds)
                    sim.t = t
                    sim.device_state = ds
                if obs_ids:
                    vals = jax.device_get(observe_j(ds))
                    for i, v in zip(obs_ids, vals):
                        sim.algorithms[i].write(sim, t, v)
                for i in host_ids:
                    sim.algorithms[i].make_step(sim, t)
                if host_ids:
                    # host algorithms may replace sim.device_state (e.g. the
                    # Wang-Landau refinement step); resync the local handle
                    ds = sim.device_state

    if sim.t < sim.steps:
        ds = advance_j(ds, masks, sim.steps - sim.t)
        check_state(ds)
        sim.t = sim.steps
    sim.device_state = ds


def _group_events(sync_ts, events):
    """Split sorted sync times into maximal runs with identical firing
    signature and constant stride."""
    groups = []
    i, n = 0, len(sync_ts)
    while i < n:
        t0 = sync_ts[i]
        sig = (tuple(events[t0][0]), tuple(events[t0][1]))
        j = i + 1
        stride = None
        while j < n:
            tj = sync_ts[j]
            if (tuple(events[tj][0]), tuple(events[tj][1])) != sig:
                break
            s = tj - sync_ts[j - 1]
            if stride is None:
                stride = s
            elif s != stride:
                break
            j += 1
        groups.append((sync_ts[i:j], sig[0], list(sig[1])))
        i = j
    return groups


# -- summary.log (ref ``src/simulation.jl:124-172``) ------------------------

def _write_summary(sim: Simulation):
    with open(os.path.join(sim.path, "summary.log"), "w") as f:
        f.write("SIMULATION SUMMARY\n\n")
        f.write("Simulation:\n")
        f.write(f"\tSteps: {sim.steps}\n")
        f.write(f"\tNumber of chains: {sim.n_chains}\n")
        f.write(f"\tNumber of algorithms: {len(sim.algorithms)}\n")
        f.write(f"\tVerbose: {sim.verbose}\n")
        f.write(f"\tStarted on {datetime.datetime.now()}\n\n")
        f.write("System:\n")
        f.write(f"\t{sim.system.name}\n")
        # per-type state dump (ref ``write_system`` overloads,
        # ``src/simulation.jl:119-122``): one line per state field with the
        # per-chain shape and dtype
        leaves = jax.tree_util.tree_leaves_with_path(sim.chains0)
        for path, leaf in leaves:
            label = jax.tree_util.keystr(path).lstrip(".")
            shape = tuple(np.shape(leaf))[1:]  # drop the chain axis
            dtype = np.asarray(leaf).dtype if not hasattr(leaf, "dtype") \
                else leaf.dtype
            f.write(f"\t\t{label}: shape {shape or '()'} dtype {dtype}\n")
        f.write("\n")
        f.write("Algorithms:\n")
        for alg, sched in zip(sim.algorithms, sim.schedulers):
            alg.write_summary(f, sched)
        f.write("\n")


def _update_summary(sim: Simulation, sim_time: float):
    with open(os.path.join(sim.path, "summary.log"), "a") as f:
        f.write("Report:\n")
        f.write(f"\tSimulation time: {sim_time} s\n")


def _finalise_summary(sim: Simulation):
    total = 0
    for root, _, files in os.walk(sim.path):
        for fn in files:
            try:
                total += os.path.getsize(os.path.join(root, fn))
            except OSError:
                pass
    with open(os.path.join(sim.path, "summary.log"), "a") as f:
        f.write(f"\tSimulation size: {total / 1024 ** 2} MB\n")
        f.write(f"\tStatus: Completed on {datetime.datetime.now()}\n")
