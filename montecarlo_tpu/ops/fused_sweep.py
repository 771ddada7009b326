"""Pallas (Triton) fused Metropolis sweep for 1-D scalar systems.

The flagship's fast path (particle-1d harmonic, 10^4 chains): one thread
owns one chain and keeps it in a register for a whole recorder segment,
drawing its random numbers from a counter-based hash, making Box–Muller
Gaussian proposals and testing acceptance in log space — one kernel launch
per recorder segment instead of one XLA step per Metropolis sweep.

Semantically equivalent to the generic `mc_step` path for a single symmetric
Gaussian displacement move (the logq forward/backward terms of
``src/metropolis.jl:183`` cancel exactly for this policy, so the acceptance
rule reduces to ``log u < Δlogp``); the random stream differs (a hash of
(seed, step pair, chain index) instead of threefry), which changes
individual trajectories but not the sampled distribution.  Because the hash
is keyed by the GLOBAL chain index, results do not depend on the block size,
the padding or the chain sharding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

__all__ = ["fused_gaussian_sweep", "sharded_gaussian_sweep", "grid_for"]

#: chains per program (one chain per thread) and warps per program, chosen
#: by a block-size sweep on the H100 (see PERF.md)
BLOCK = 32
NUM_WARPS = 1


def grid_for(m: int, block: int = BLOCK):
    """``(padded chain count, number of programs)`` for ``m`` chains in
    blocks of ``block`` (a power of two)."""
    if block <= 0 or block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    n_blocks = max(1, -(-m // block))
    return n_blocks * block, n_blocks


def _uniform_from_bits(bits):
    """uint32 bits -> float32 uniform in (0, 1].

    Mantissa trick: force exponent to [1,2), subtract from 2.0 so the result
    is in (0, 1] (safe for log)."""
    f = jax.lax.bitcast_convert_type(
        (bits >> 9) | jnp.uint32(0x3F800000), jnp.float32)
    return 2.0 - f


def _hash32(s):
    """Murmur3-style finalizer: decorrelates adjacent per-step seeds."""
    s = s * jnp.int32(-2048144789)          # 0x85EBCA6B
    s = s ^ jax.lax.shift_right_logical(s, 13)
    s = s * jnp.int32(-1028477387)          # 0xC2B2AE35
    s = s ^ jax.lax.shift_right_logical(s, 16)
    return s


def hash_bits(step_seed, draw: int, idx):
    """Counter-based uint32 bits for chain indices ``idx`` (int32 array):
    two murmur-finalizer rounds over (seed, draw index, chain index)."""
    h = idx * jnp.int32(-1640531527) + step_seed          # 0x9E3779B9
    # wrap the static draw tag through uint32 (draw >= 3 would overflow a
    # direct jnp.int32(...) construction)
    tag = int(np.uint32(draw * 0x3243F6A9).view(np.int32))
    h = _hash32(h ^ jnp.int32(tag))
    h = _hash32(h + jnp.int32(draw))
    return jax.lax.bitcast_convert_type(h, jnp.uint32)


def _sweep_kernel(potential, block, seed_ref, t0_ref, nsteps_ref, off_ref,
                  sigma_ref, x_ref, beta_ref, x_out, e_out, acc_out):
    sigma = sigma_ref[0]
    seed = seed_ref[0]
    beta = beta_ref[...]
    idx = (off_ref[0] + pl.program_id(0) * block
           + jax.lax.broadcasted_iota(jnp.int32, (block,), 0))
    n_steps = nsteps_ref[0]
    t0 = t0_ref[0]
    t_end = t0 + n_steps
    # pairs are aligned to ABSOLUTE micro-steps (2p, 2p+1), so trajectories
    # stay invariant to how recorder schedules slice the run into segments
    # — a segment starting mid-pair masks the pair's first half
    p0 = t0 >> 1
    n_pairs = jnp.where(n_steps > 0, ((t_end - 1) >> 1) - p0 + 1, 0)

    def body(j, carry):
        """TWO MH steps per iteration: Box–Muller yields a PAIR of exact
        independent standard normals (the cos and sin halves of the same
        draws), so a double-step costs 4 hashed draws instead of 6."""
        x, acc = carry
        p = p0 + j
        # re-seed per absolute pair index (counter-based, like the generic
        # path's fold_in(t))
        step_seed = _hash32(seed + p)
        u1, u2, u3, u4 = (_uniform_from_bits(hash_bits(step_seed, k, idx))
                          for k in range(4))
        r = jnp.sqrt(-2.0 * jnp.log(u1))
        theta = (2.0 * jnp.pi) * u2
        z1 = r * jnp.cos(theta)
        z2 = r * jnp.sin(theta)

        live1 = (2 * p >= t0) & (2 * p < t_end)
        xn = x + sigma * z1
        accept = live1 & (jnp.log(u3) < beta * (potential(x)
                                                - potential(xn)))
        x = jnp.where(accept, xn, x)
        acc = acc + accept.astype(jnp.int32)

        live2 = 2 * p + 1 < t_end
        xn = x + sigma * z2
        accept = live2 & (jnp.log(u4) < beta * (potential(x)
                                                - potential(xn)))
        x = jnp.where(accept, xn, x)
        acc = acc + accept.astype(jnp.int32)
        return x, acc

    x, acc = jax.lax.fori_loop(
        0, n_pairs, body, (x_ref[...], jnp.zeros((block,), jnp.int32)))
    x_out[...] = x
    e_out[...] = potential(x)
    acc_out[...] = acc


@functools.partial(jax.jit, static_argnames=("potential", "interpret",
                                             "block", "num_warps"))
def fused_gaussian_sweep(x, beta, sigma, seed, t0, n_steps, offset=0, *,
                         potential, interpret=False, block=BLOCK,
                         num_warps=NUM_WARPS):
    """Run ``n_steps`` Metropolis sweeps of a Gaussian displacement move over
    all chains inside one Pallas kernel (Triton route).

    The chain axis is padded to a multiple of ``block`` and split over a
    1-D grid of ``ceil(M / block)`` programs, one chain per thread.

    Args:
      x: (M,) float32 positions.
      beta: (M,) float32 inverse temperatures.
      sigma: scalar proposal width (traced).
      seed: int32 scalar base seed (traced).
      t0: int32 scalar absolute step offset — step pair p uses seed
        ``hash(seed + p)``, making results segmentation-invariant.
      n_steps: int32 scalar number of MH steps (traced; dynamic trip count).
      offset: int32 global index of chain 0 (the shard offset under a mesh).
      potential: static elementwise callable U(x).

    Returns:
      (x', e', accepted) with accepted: (M,) int32 acceptance counts for this
      segment.
    """
    m = x.shape[0]
    m_pad, n_blocks = grid_for(m, block)
    pad = lambda a: jnp.pad(a.astype(jnp.float32), (0, m_pad - m))
    scalar = lambda v, dt: jnp.asarray(v, dt).reshape(1)
    one = pl.BlockSpec((1,), lambda i: (0,))
    blk = pl.BlockSpec((block,), lambda i: (i,))
    x_out, e_out, acc = pl.pallas_call(
        functools.partial(_sweep_kernel, potential, block),
        grid=(n_blocks,),
        out_shape=(
            jax.ShapeDtypeStruct((m_pad,), jnp.float32),
            jax.ShapeDtypeStruct((m_pad,), jnp.float32),
            jax.ShapeDtypeStruct((m_pad,), jnp.int32),
        ),
        in_specs=[one, one, one, one, one, blk, blk],
        out_specs=(blk, blk, blk),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name="gaussian_sweep",
    )(
        scalar(seed, jnp.int32), scalar(t0, jnp.int32),
        scalar(n_steps, jnp.int32), scalar(offset, jnp.int32),
        scalar(sigma, jnp.float32), pad(x), pad(beta),
    )
    return x_out[:m], e_out[:m], acc[:m]


def sharded_gaussian_sweep(mesh, axis, x, beta, sigma, seed, t0, n_steps, *,
                           potential, interpret=False):
    """Multi-device fused sweep: each shard runs the kernel on its local
    chains under ``shard_map``, with the shard's global chain offset as the
    hash counter, so the result is bitwise that of one device."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    def local(x_l, beta_l, sigma_l, seed_l, t0_l, n_l):
        off = jax.lax.axis_index(axis).astype(jnp.int32) * x_l.shape[0]
        return fused_gaussian_sweep(x_l, beta_l, sigma_l, seed_l, t0_l, n_l,
                                    off, potential=potential,
                                    interpret=interpret)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(axis), P(axis), P(), P(), P(), P()),
                   out_specs=(P(axis), P(axis), P(axis)),
                   check_vma=False)
    return fn(x, beta, jnp.asarray(sigma, jnp.float32),
              jnp.asarray(seed, jnp.int32), jnp.asarray(t0, jnp.int32),
              jnp.asarray(n_steps, jnp.int32))
