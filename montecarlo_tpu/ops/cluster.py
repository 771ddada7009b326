"""Whole-lattice connected-component labelling for cluster Monte Carlo.

The reference engine offers only single-proposal Metropolis–Hastings
(``src/metropolis.jl:176-190``); cluster algorithms (Swendsen–Wang, Wolff) are
the standard next capability on lattice systems and the textbook formulations
are sequential flood fills — useless on an accelerator.  This module
provides the vectorised primitive both need: given per-bond activation masks on a periodic
2-D lattice, label every activated-bond connected component, as a fixpoint of
fused (L, L) vector ops.

Algorithm: *min-label propagation with pointer jumping*.

1. Every site starts with its own label (its linear index).
2. Each sweep takes the minimum of a site's label and the labels of the up to
   four neighbours reachable through active bonds — four ``jnp.roll`` +
   ``where`` + ``minimum`` ops over the whole lattice.
3. A pointer-jumping step then replaces each site's label by the label of the
   site it points at (``l = l.flat[l]``), doubling the distance information
   travels per iteration (Shiloach–Vishkin style shortcutting).
4. Iterate under ``lax.while_loop`` until a fixpoint; convergence is
   O(log(diameter)) iterations instead of O(diameter) for plain propagation.

The result: ``labels[i, j]`` is the minimum linear index over the connected
component of site (i, j) — a canonical component id usable as a gather index
to broadcast one random draw per cluster to all its sites.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["component_labels", "seed_component_mask"]


def _min_propagate(labels, act_right, act_down):
    """One sweep: min over self + bond-connected neighbours (4 rolls)."""
    big = labels  # alias for readability
    # right bond connects (i, j) <-> (i, j+1); act_right[i, j] gates it
    from_right = jnp.where(act_right, jnp.roll(big, -1, 1), big)
    from_left = jnp.where(jnp.roll(act_right, 1, 1), jnp.roll(big, 1, 1), big)
    # down bond connects (i, j) <-> (i+1, j); act_down[i, j] gates it
    from_down = jnp.where(act_down, jnp.roll(big, -1, 0), big)
    from_up = jnp.where(jnp.roll(act_down, 1, 0), jnp.roll(big, 1, 0), big)
    return jnp.minimum(
        jnp.minimum(jnp.minimum(from_right, from_left),
                    jnp.minimum(from_down, from_up)), big)


def component_labels(act_right, act_down):
    """Label activated-bond connected components of a periodic 2-D lattice.

    Args:
      act_right: (L1, L2) bool — bond (i, j)–(i, j+1 mod L2) active.
      act_down:  (L1, L2) bool — bond (i, j)–(i+1 mod L1, j) active.

    Returns:
      (L1, L2) int32 array; sites share a value iff they are connected through
      active bonds, and the value is the component's minimum linear index.
    """
    lx, ly = act_right.shape
    init = jnp.arange(lx * ly, dtype=jnp.int32).reshape(lx, ly)

    def cond(carry):
        _, changed = carry
        return changed

    def body(carry):
        labels, _ = carry
        new = _min_propagate(labels, act_right, act_down)
        # pointer jumping: adopt the label currently held by the site my
        # label points at — path compression, turns O(diameter) into O(log)
        new = new.reshape(-1)[new.reshape(-1)].reshape(lx, ly)
        return new, jnp.any(new != labels)

    labels, _ = jax.lax.while_loop(cond, body, (init, jnp.asarray(True)))
    return labels


def seed_component_mask(act_right, act_down, site):
    """Boolean mask of the component containing linear ``site``.

    The Wolff primitive: dilate a one-hot seed through active bonds until
    fixpoint.  O(cluster diameter) iterations of four rolls; cheaper than full
    labelling when only one cluster is needed.
    """
    lx, ly = act_right.shape
    mask = (jnp.zeros((lx * ly,), bool).at[site].set(True)).reshape(lx, ly)

    def dilate(mask):
        return (mask
                | jnp.roll(mask & act_right, 1, axis=1)
                | (jnp.roll(mask, -1, axis=1) & act_right)
                | jnp.roll(mask & act_down, 1, axis=0)
                | (jnp.roll(mask, -1, axis=0) & act_down))

    def cond(carry):
        _, changed = carry
        return changed

    def body(carry):
        mask, _ = carry
        new = dilate(mask)
        return new, jnp.any(new != mask)

    mask, _ = jax.lax.while_loop(cond, body, (mask, jnp.asarray(True)))
    return mask
