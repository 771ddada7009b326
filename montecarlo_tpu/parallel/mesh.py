"""Chain-axis sharding over a device mesh.

The reference's only parallelism is chains-over-OS-threads via Transducers
(``src/metropolis.jl:265``, SURVEY §2 "Parallelism strategies").  The
accelerator equivalent: a 1-D ``jax.sharding.Mesh`` over all devices
(NVLink within a host, the network across hosts, transparently), with every chain-major leaf
of the device-state pytree sharded ``P('chains')`` and everything else
(move parameters, step counter, gradient accumulators) replicated.

Because the compiled time loop is elementwise over the chain axis except for
explicit reductions (acceptance stats, GradientData sums, callback means),
GSPMD partitions it without any code changes — the reductions lower to
``psum`` collectives, replacing the reference's threaded fold
(``src/PolicyGuided/estimator.jl:94``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_device_state", "replicate", "CHAIN_AXIS"]

CHAIN_AXIS = "chains"


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
              axis: str = CHAIN_AXIS) -> Mesh:
    """1-D mesh over ``devices`` (default: all of ``jax.devices()``)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def shard_device_state(dstate, mesh: Mesh, n_chains: int,
                       axis: str = CHAIN_AXIS):
    """Place a device-state pytree on ``mesh``: leaves whose leading dim is
    the chain count are sharded along ``axis``; all others replicated.

    ``n_chains`` must divide the mesh size evenly (pad the chain count up if
    needed — independent chains make padding harmless).
    """
    n_dev = mesh.devices.size
    if n_chains % n_dev != 0:
        raise ValueError(
            f"n_chains={n_chains} not divisible by mesh size {n_dev}; "
            "pad the chain count (extra independent chains are free)")
    sharded = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    multiproc = jax.process_count() > 1

    def build(leaf, sharding):
        if not multiproc:
            return jax.device_put(leaf, sharding)
        # Multi-host: every process computes the same full value
        # deterministically; assemble the global array from local slices.
        is_key = jnp.issubdtype(leaf.dtype, jax.dtypes.prng_key)
        data = np.asarray(jax.random.key_data(leaf) if is_key else leaf)
        arr = jax.make_array_from_callback(
            data.shape, sharding, lambda idx: data[idx])
        return jax.random.wrap_key_data(arr) if is_key else arr

    def place(leaf):
        leaf = jax.numpy.asarray(leaf)
        if leaf.ndim >= 1 and leaf.shape[0] == n_chains:
            return build(leaf, sharded)
        return build(leaf, repl)

    return jax.tree_util.tree_map(place, dstate)


def fetch(tree):
    """Device→host transfer that works for sharded multi-host arrays
    (all-gathers non-addressable leaves) and PRNG key arrays."""
    def get(leaf):
        if not isinstance(leaf, jax.Array):
            return np.asarray(leaf)
        is_key = jnp.issubdtype(leaf.dtype, jax.dtypes.prng_key)
        if is_key:
            leaf = jax.random.key_data(leaf)
        if not leaf.is_fully_addressable:
            from jax.experimental import multihost_utils
            leaf = multihost_utils.process_allgather(leaf, tiled=True)
        return np.asarray(leaf)

    return jax.tree_util.tree_map(get, tree)


def replicate(tree, mesh: Mesh):
    """Replicate a pytree across the mesh."""
    repl = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda leaf: jax.device_put(jax.numpy.asarray(leaf), repl), tree)
