"""Observability algorithms: throughput meter and profiler trace hooks.

The reference's only performance observability is a wall-clock ``@elapsed``
written to ``summary.log`` (``src/simulation.jl:184,193``; SURVEY §5 calls
for "jax.profiler trace hooks + steps/s throughput meter as a recorder" in
this build).  Both are plain algorithms schedulable like any recorder.
"""

from __future__ import annotations

import os
import time

import jax

from ..core.algorithms import HostAlgorithm, _io_host

__all__ = ["Throughput", "ProfilerTrace"]


class Throughput(HostAlgorithm):
    """Writes ``throughput.dat`` lines ``t steps_per_sec`` measured between
    its scheduled firings (chain-aggregate Metropolis steps/s)."""

    def __init__(self, sim, dependencies=(), **_):
        self.path = os.path.join(sim.path, "throughput.dat")
        self.n_chains = sim.n_chains
        self._last_t = 0
        self._last_wall = None
        self.file = None

    def initialise(self, sim):
        # multi-host: every process measures (the sync participates in the
        # step), but only the IO host writes the shared file
        if _io_host():
            self.file = open(self.path, "w")
        self._last_t = sim.t
        self._last_wall = time.perf_counter()

    def make_step(self, sim, t):
        # wait for the device so the interval measures real execution
        jax.block_until_ready(sim.device_state)
        now = time.perf_counter()
        dt_steps = (t - self._last_t) * self.n_chains
        wall = now - self._last_wall
        if self.file is not None and wall > 0 and dt_steps > 0:
            self.file.write(f"{t} {dt_steps / wall!r}\n")
            self.file.flush()
        self._last_t, self._last_wall = t, now

    def finalise(self, sim):
        if self.file:
            self.file.close()
            self.file = None


class ProfilerTrace(HostAlgorithm):
    """Captures a ``jax.profiler`` trace between its first and second
    scheduled firings (inspect with TensorBoard / xprof)."""

    def __init__(self, sim, dependencies=(), trace_dir=None, **_):
        self.trace_dir = trace_dir or os.path.join(sim.path, "trace")
        self._active = False

    def make_step(self, sim, t):
        if not _io_host():
            return  # one trace per run: only the IO host profiles
        if not self._active:
            jax.profiler.start_trace(self.trace_dir)
            self._active = True
        else:
            jax.block_until_ready(sim.device_state)
            jax.profiler.stop_trace()
            self._active = False

    def finalise(self, sim):
        if self._active:
            try:
                jax.profiler.stop_trace()
            finally:
                self._active = False
