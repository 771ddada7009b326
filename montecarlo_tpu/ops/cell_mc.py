"""Checkerboard cell-list Monte Carlo for large-N particle systems (2-D/3-D).

The O(N)-per-move generic row path caps particle MC at N ~ 10^3:
every attempt touches all N rows and attempts are sequential.  This module
implements the massively-parallel alternative (the cell decomposition of
Anderson, Lechner & Glotzer's checkerboard GPU MC, re-derived in plain XLA):

- The box is divided into an ``nc^dim`` grid of cells (``nc`` even, >= 4) of
  real-space width ``w = box / nc >= rcut + 2 * d_cap``.
- Cells are 2^dim-colored in a checkerboard.  In one *substep*, every cell
  of one color proposes a move for ONE uniformly-picked occupant.  Two
  active cells are never adjacent, and every particle stays within
  ``d_cap`` of its *storage cell* (moves that would leave the cell's
  ``+/- d_cap`` halo are rejected — a symmetric proposal-set restriction
  that preserves detailed balance), so simultaneous moves are provably
  non-interacting and each substep is a product of independent MH updates:
  pi-invariant by the standard checkerboard argument.
- **Random grid origin per bind**: the storage grid is shifted by a
  per-chain uniform offset in [0, w)^dim drawn fresh at every bind (folded
  off the segment key).  A fixed-origin grid is NOT pi-invariant across
  segments — particles can end a segment up to ``d_cap`` outside their
  storage cell, making the halo coverage (x2 in edge bands, x4/x8 in
  corners) a position-dependent, grid-commensurate bias in the
  long-segment limit.  Averaging over a uniform origin makes the halo
  coverage position-independent — the standard GPU-checkerboard remedy —
  restoring exact stationarity of the segment kernel composed with its
  random bind.
- A particle's interactions always lie inside its 3^dim cell
  neighbourhood: any partner within ``rcut`` of a position in cell
  ``+/- d_cap`` sits within boundary distance ``rcut + 2 d_cap <= w`` of
  the cell, i.e. in an adjacent cell.  Neighbour access is 3^dim static
  torus rolls of the ``(nc, ..., C)`` cell arrays — no gathers, no sorts
  inside the hot loop.
- Geometry is **fractional** (positions stored as ``s = pos / box`` in
  [0, 1)): the grid plan is box-independent, so every chain can carry its
  OWN box edge (traced) — constant-pressure (NPT) runs stay on the cell
  path.  A chain is only valid while ``box >= nc * (rcut + 2 d_cap)``;
  violating chains no-op their segment and latch the ``invalid`` flag.
- **Volume substeps** (optional): an ln-V rescale per chain on the bound
  state — fractional coordinates are invariant under the rescale, so no
  re-bind is needed; the full energy at the proposed box is one
  all-cells 3^dim-neighbourhood pass.  Proposals outside the grid's valid
  box range are rejected (a symmetric proposal-set restriction, like the
  anchor halo).  A volume substep costs ~2^dim x cap displacement
  substeps while delivering ONE attempt, so weight volume moves like
  production NPT (~one attempt per sweep, w_vol ~ 1/N), not as an
  equal-attempt peer — a heavy w_vol dominates wall clock.
- Between segments, particles are re-binned (one argsort per chain) at a
  fresh random origin, restoring full ergodicity; within a segment the
  anchor constraint makes re-binning unnecessary by construction.

Per displacement substep ~``nc^dim / 2^dim`` moves execute in parallel per
chain; the tensors are wide enough (``(B, nc, ..., C)``) that plain XLA
amortises per-op overhead — no Pallas needed, and chain-axis sharding falls
out of vmap + sharding propagation.  Throughput per move is O(3^dim C)
instead of O(N): independent of N at fixed density.

Capability target: ParticlesMC-scale 2-D/3-D systems (N = 10^4+) the
reference organisation's ecosystem runs (``/root/reference/README.md:33``).
"""

from __future__ import annotations

import functools
import itertools
import math

import jax
import jax.numpy as jnp

__all__ = ["CellGrid", "plan_grid", "bind_cells", "unbind_cells",
           "cell_total_energy", "cell_mc_segment"]


class CellGrid:
    """Static cell-decomposition plan (python-level; hashable).

    ``box`` is the *planning* box (used only to choose ``nc``); the segment
    kernel takes the actual per-chain box as a traced input and only
    requires ``box >= nc * wmin`` with ``wmin = rcut + 2 d_cap``.
    """

    def __init__(self, nc: int, cap: int, box: float, d_cap: float,
                 rcut: float, dim: int = 2):
        self.nc = int(nc)
        self.cap = int(cap)
        self.box = float(box)
        self.dim = int(dim)
        self.w = self.box / self.nc          # planning-box cell width
        self.d_cap = float(d_cap)
        self.rcut = float(rcut)
        self.wmin = self.rcut + 2.0 * self.d_cap
        self.box_min = self.nc * self.wmin   # smallest valid box edge

    def __repr__(self):
        return (f"CellGrid(nc={self.nc}, cap={self.cap}, box={self.box}, "
                f"d_cap={self.d_cap}, rcut={self.rcut}, dim={self.dim})")

    def _key(self):
        return (self.nc, self.cap, self.box, self.d_cap, self.rcut, self.dim)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, CellGrid) and self._key() == other._key()


def plan_grid(n_particles: int, box: float, rcut: float,
              d_cap: float = 0.45, cap_slack: float = 2.0, dim: int = 2,
              max_occupancy: int = None, box_margin: float = 0.0) -> CellGrid:
    """Choose the largest even cell grid with ``w >= rcut + 2 d_cap``.

    ``box_margin`` shrinks the box used for planning by that fraction, so
    the grid stays valid down to ``box * (1 - box_margin)`` — headroom for
    NPT compression (volume proposals below ``grid.box_min`` are rejected).

    ``cap`` (slots per cell) is the larger of ``mean occupancy x
    cap_slack`` and ``max_occupancy + 2`` (the observed initial per-cell
    maximum, when the caller measured one — binding latches an invalid
    flag if ever exceeded), rounded up to a multiple of 8 (whole
    vector widths for the gathers).  Raises if the box only fits a grid smaller than 4^dim
    (cell MC needs >= 4 cells per axis so the 3^dim torus rolls are
    distinct cells).
    """
    plan_box = box * (1.0 - box_margin)
    nc = int(plan_box / (rcut + 2.0 * d_cap))
    nc -= nc % 2
    if nc < 4:
        raise ValueError(
            f"box {box:.3g} too small for cell MC with rcut {rcut}, "
            f"d_cap {d_cap} and margin {box_margin}: need >= 4 cells per "
            f"axis")
    mean_occ = n_particles / (nc ** dim)
    cap = mean_occ * cap_slack
    if max_occupancy is not None:
        # quantile-style sizing: the observed max + slack beats a mean
        # multiple for clustered configurations (ADVICE r4: near-Poisson
        # occupancy overflows a mean-based cap routinely)
        cap = max(cap, max_occupancy + 2.0)
    cap = max(8, int(math.ceil(cap / 8.0)) * 8)
    return CellGrid(nc=nc, cap=cap, box=box, d_cap=d_cap, rcut=rcut,
                    dim=dim)


# ---------------------------------------------------------------------------
# Binding: flat (N, ...) particle arrays <-> (nc, ..., C) cell arrays
# ---------------------------------------------------------------------------
# Coordinates are FRACTIONAL (s in [0, 1)); cell arrays hold them stacked on
# a leading axis: cells["crd"] has shape (dim, nc, ..., C) so the minor
# (lane) dimension stays the wide slot axis.

def bind_cells(grid: CellGrid, s, attr):
    """Bin ONE chain's particles (fractional coords) into cell slots.

    Args:
      s: (N, dim) fractional positions in [0, 1).
      attr: (N,) per-particle attribute (species label / diameter).

    Returns dict of cell arrays: ``crd`` (dim, nc, ..., C) fractional
    coordinates, ``attr``, ``occ`` (bool occupancy), ``idx`` (original
    particle index, N where empty) — each (nc, ..., C) — plus
    ``overflow``, a scalar bool flagging any cell fuller than C (checked
    by the caller; the segment is invalid if set).
    """
    n = s.shape[0]
    nc, cap, dim = grid.nc, grid.cap, grid.dim
    ci = jnp.clip((s * nc).astype(jnp.int32), 0, nc - 1)   # (N, dim)
    cid = ci[:, 0]
    for a in range(1, dim):
        cid = cid * nc + ci[:, a]
    order = jnp.argsort(cid, stable=True)
    cid_s = cid[order]
    r = jnp.arange(n)
    is_new = jnp.concatenate(
        [jnp.ones((1,), bool), cid_s[1:] != cid_s[:-1]])
    seg_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_new, r, 0))
    rank = r - seg_start
    overflow = jnp.any(rank >= cap)
    slot = cid_s * cap + jnp.minimum(rank, cap - 1)
    shape = (nc,) * dim + (cap,)

    def scatter(src, fill, dtype=None):
        out = jnp.full((nc ** dim * cap,), fill,
                       src.dtype if dtype is None else dtype)
        return out.at[slot].set(src[order]).reshape(shape)

    crd = jnp.stack([scatter(s[:, a], 0.0) for a in range(dim)], axis=0)
    return {
        "crd": crd,
        "attr": scatter(attr.astype(jnp.float32), 0.0),
        "occ": scatter(jnp.ones((n,), bool), False),
        "idx": scatter(jnp.arange(n, dtype=jnp.int32), n),
        "overflow": overflow,
    }


def unbind_cells(cells, n: int):
    """Inverse of :func:`bind_cells`: flat (N, dim) fractional positions +
    (N,) attr in the ORIGINAL particle order (via the stored ``idx`` map)."""
    idx = cells["idx"].reshape(-1)
    dim = cells["crd"].shape[0]
    s = jnp.stack(
        [jnp.zeros((n,), jnp.float32).at[idx].set(
            cells["crd"][a].reshape(-1), mode="drop") for a in range(dim)],
        axis=-1)
    attr = jnp.zeros((n,), jnp.float32).at[idx].set(
        cells["attr"].reshape(-1), mode="drop")
    return s, attr


def _roll(a, off, spatial0):
    """Torus roll of a cell array: entry [c] of the result holds cell
    [c + off] (periodic).  ``spatial0`` is the array axis of the first
    spatial dimension (0 for plain fields, 1 for packed/leading-axis)."""
    return jnp.roll(a, shift=tuple(-d for d in off),
                    axis=tuple(range(spatial0, spatial0 + len(off))))


# ---------------------------------------------------------------------------
# The substep
# ---------------------------------------------------------------------------

def _make_substep(grid: CellGrid, pair_energy, rcut2_of, swap_mode=None,
                  proposal="gaussian", vol=None):
    """Build the one-color multi-move MH substep for ONE chain.

    ``pair_energy(r2, a_i, a_j) -> u`` and ``rcut2_of(a_i, a_j) -> rc^2``
    define the model (attributes are the species labels / diameters).

    The substep is built per COLOR (a static parity tuple in {0,1}^dim):
    only the active color's ``(nc/2, ..., C)`` sub-grid computes proposals
    and energies — the driver dispatches the variants through a
    ``lax.switch`` on a substep-shared draw, so each substep pays for the
    active fraction only (not a masked full-grid pass).

    ``swap_mode`` adds a second substep family — WITHIN-CELL attribute
    swaps, the cell-parallel form of swap MC:

    - ``"species"`` (binary LJ): exchange the species of one A and one B
      occupant of each active cell.  The cell's (n_A, n_B) counts are
      invariant under the exchange, so the ``1/(n_A n_B)`` pick
      probabilities cancel exactly.
    - ``"pair"`` (polydisperse): exchange the diameters of an ordered pair
      of distinct occupants; ``1/(n (n-1))`` cancels likewise.

    Swapped particles never move, so simultaneous same-color swaps are
    independent by the same ``w >= rcut + 2 d_cap`` geometry as
    displacements (every affected pair term stays inside the 3^dim
    neighbourhoods of the two cells, which are > rcut apart).

    ``vol = (n_particles, pressure)`` adds a third family — per-chain ln-V
    volume rescales on the bound state (fractional coordinates are
    invariant; one full-energy pass at the proposed box).
    """
    nc, cap, dim = grid.nc, grid.cap, grid.dim
    d_cap = grid.d_cap
    h = nc // 2
    offsets = tuple(itertools.product((-1, 0, 1), repeat=dim))
    centre = offsets.index((0,) * dim)
    n_off = len(offsets)
    # packed half-slicing moves less data on small (dispatch-bound) grids;
    # contiguous per-field rolls win on large (bandwidth-bound) ones.
    # measured crossover ~576 cells in 2-D (nc=24); reuse the cell count.
    packed_path = nc ** dim <= 24 ** 2

    def _shifted_half(a, axis, parity, d):
        """Cells ``parity + d + 2k`` (periodic) along ``axis``, in
        active-cell order — a strided half-slice plus a +/-1 roll of the
        HALVED axis when the offset wraps (o = parity + d is in
        {-1, 0, 1, 2} only).  Moves ~2^dim x less data than slicing a
        full-grid torus roll."""
        o = parity + d
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(o % 2, None, 2)
        b = a[tuple(sl)]
        if o == -1:
            b = jnp.roll(b, 1, axis=axis)
        elif o == 2:
            b = jnp.roll(b, -1, axis=axis)
        return b

    def make_stack_nbhd(parity):
        sl = tuple(slice(p, None, 2) for p in parity)

        def stack_nbhd(cells):
            """One packed stacked neighbourhood (crd..., attr, occ), built
            once per substep and shared by all energy passes — an order of
            magnitude fewer op dispatches than a per-offset per-field loop
            (the XLA path is dispatch/bandwidth-bound, not flop-bound, at
            these tile sizes).  Fields pack on the LEADING axis so the
            minor (lane) dimension stays the wide 3^dim*C slot axis.

            Returns ``(crd9, as9, ok9)`` with crd9 (dim, h, ..., n_off*C).
            """
            if packed_path:
                packed = jnp.concatenate(
                    [cells["crd"],
                     cells["attr"][None],
                     cells["occ"].astype(jnp.float32)[None]], axis=0)
                blocks = []
                for off in offsets:
                    b = packed
                    for a in range(dim):
                        b = _shifted_half(b, a + 1, parity[a], off[a])
                    blocks.append(b)
                nb = jnp.concatenate(blocks, axis=-1)
                return nb[:dim], nb[dim], nb[dim + 1] > 0.5
            stack = lambda a, s0: jnp.concatenate(
                [_roll(a, off, s0)[(slice(None),) * s0 + sl]
                 for off in offsets], axis=-1)
            return (stack(cells["crd"], 1), stack(cells["attr"], 0),
                    stack(cells["occ"], 0))

        return stack_nbhd

    def excl_centre(occ9, sel):
        """Occupancy with the (h, ..., C) one-hot ``sel`` masked out of the
        centre block (the mover's / swappers' own slots)."""
        return occ9 & jnp.logical_not(
            jnp.zeros_like(occ9).at[
                ..., centre * cap:(centre + 1) * cap].set(sel))

    def energy_at(pc, pa, crd9, as9, ok9, box2):
        """Interaction energy of a probe at fractional coords ``pc``
        (tuple of dim arrays (h, ..., 1)) against the stacked
        neighbourhood; fractional min-image distances are scaled to real
        units ONCE after the axis sum (box2 = box^2 per chain) — one
        fewer multiply per lane per axis than scaling each delta."""
        r2 = 0.0
        for a in range(dim):
            d = crd9[a] - pc[a]
            d = d - jnp.round(d)
            r2 = r2 + d * d
        r2 = r2 * box2
        u_p = pair_energy(r2, pa, as9)
        ok = ok9 & (r2 < rcut2_of(pa, as9))
        return jnp.sum(jnp.where(ok, u_p, 0.0), axis=-1)

    def gumbel_pick(key, mask):
        """(h, ..., C) one-hot uniform pick among ``mask`` slots (empty
        mask -> all-False one-hot), lowest slot breaking float ties."""
        u = jax.random.uniform(key, mask.shape)
        score = jnp.where(mask, u, -1.0)
        sel = score == jnp.max(score, axis=-1, keepdims=True)
        first = jnp.cumsum(sel.astype(jnp.int32), axis=-1) == 1
        return sel & first & mask

    def make_color(parity):
        # static geometry of the active sub-grid, in fractional units: the
        # active cell origin along axis a is (2k + parity[a]) / nc
        act0 = []
        for a in range(dim):
            shape = [1] * (dim + 1)
            shape[a] = h
            act0.append(((jnp.arange(h, dtype=jnp.float32) * 2 + parity[a])
                         / nc).reshape(shape))
        stack9 = make_stack_nbhd(parity)
        sl = tuple(slice(p, None, 2) for p in parity)

        def color_substep(cells, e_tot, box, key, sigma, beta):
            kpick, kprop, kacc = jax.random.split(key, 3)
            occ_a = cells["occ"][sl]              # (h, ..., C)

            # uniform occupant pick per active cell
            sel = gumbel_pick(kpick, occ_a)
            has = jnp.any(occ_a, axis=-1)

            pick = lambda a: jnp.sum(jnp.where(sel, a, 0.0), axis=-1,
                                     keepdims=True)
            pi = [pick(cells["crd"][a][sl]) for a in range(dim)]
            ai = pick(cells["attr"][sl])

            if proposal == "square":
                # uniform square displacement (hard-disk convention) —
                # symmetric, so the MH ratio is unchanged
                draw = jax.random.uniform(
                    kprop, (h,) * dim + (dim,), minval=-1.0, maxval=1.0)
            else:
                draw = jax.random.normal(kprop, (h,) * dim + (dim,))
            delta = (sigma / box) * draw          # fractional displacement
            pn = [pi[a] + delta[..., a:a + 1] for a in range(dim)]
            # anchor constraint: the new position must stay inside the
            # storage cell's +/- d_cap halo (keeps simultaneous moves
            # independent and the 3^dim neighbourhood sufficient for the
            # entire segment).  d_cap is real-space; box is per-chain.
            d_cap_f = d_cap / box
            w_f = 1.0 / nc
            inbox = True
            for a in range(dim):
                inbox = (inbox
                         & (pn[a][..., 0] >= act0[a][..., 0] - d_cap_f)
                         & (pn[a][..., 0] < act0[a][..., 0] + w_f + d_cap_f))

            crd9, as9, occ9 = stack9(cells)
            ok9 = excl_centre(occ9, sel)
            box2 = box * box
            d_e = (energy_at(pn, ai, crd9, as9, ok9, box2)
                   - energy_at(pi, ai, crd9, as9, ok9, box2))

            u_acc = jax.random.uniform(kacc, (h,) * dim)
            accept = has & inbox & (jnp.log(u_acc) < -beta * d_e)
            upd = sel & accept[..., None]
            crd_a = cells["crd"][(slice(None),) + sl]
            crd_new = jnp.stack(
                [jnp.where(upd, pn[a], crd_a[a]) for a in range(dim)],
                axis=0)
            cells = {**cells,
                     "crd": cells["crd"].at[(slice(None),) + sl].set(
                         crd_new)}
            e_tot = e_tot + jnp.sum(jnp.where(accept, d_e, 0.0))
            n_att = jnp.sum(has.astype(jnp.int32))
            n_acc = jnp.sum(accept.astype(jnp.int32))
            return cells, e_tot, box, n_att, n_acc

        return color_substep

    def make_color_swap(parity):
        stack9 = make_stack_nbhd(parity)
        sl = tuple(slice(p, None, 2) for p in parity)

        def swap_substep(cells, e_tot, box, key, sigma, beta):
            ki, kj, kacc = jax.random.split(key, 3)
            occ_a = cells["occ"][sl]
            attr_a = cells["attr"][sl]

            if swap_mode == "species":
                is_b = attr_a > 0.5
                sel_i = gumbel_pick(ki, occ_a & jnp.logical_not(is_b))
                sel_j = gumbel_pick(kj, occ_a & is_b)
            else:                       # "pair": ordered distinct pair
                sel_i = gumbel_pick(ki, occ_a)
                sel_j = gumbel_pick(kj, occ_a & jnp.logical_not(sel_i))
            valid = jnp.any(sel_i, axis=-1) & jnp.any(sel_j, axis=-1)

            pick = lambda s, a: jnp.sum(jnp.where(s, a, 0.0), axis=-1,
                                        keepdims=True)
            pi = [pick(sel_i, cells["crd"][a][sl]) for a in range(dim)]
            pj = [pick(sel_j, cells["crd"][a][sl]) for a in range(dim)]
            ai = pick(sel_i, attr_a)
            aj = pick(sel_j, attr_a)

            crd9, as9, occ9 = stack9(cells)
            # exclude BOTH swappers: the i-j pair term is symmetric under
            # the exchange (eps/sig tables and sigma_ij are symmetric) and
            # cancels in dE
            ok9 = excl_centre(occ9, sel_i | sel_j)
            box2 = box * box
            e_old = (energy_at(pi, ai, crd9, as9, ok9, box2)
                     + energy_at(pj, aj, crd9, as9, ok9, box2))
            e_new = (energy_at(pi, aj, crd9, as9, ok9, box2)
                     + energy_at(pj, ai, crd9, as9, ok9, box2))
            d_e = e_new - e_old

            u_acc = jax.random.uniform(kacc, (h,) * dim)
            accept = valid & (jnp.log(u_acc) < -beta * d_e)
            upd_i = sel_i & accept[..., None]
            upd_j = sel_j & accept[..., None]
            attr_new = jnp.where(upd_i, aj, jnp.where(upd_j, ai, attr_a))
            cells = {**cells,
                     "attr": cells["attr"].at[sl].set(attr_new)}
            e_tot = e_tot + jnp.sum(jnp.where(accept, d_e, 0.0))
            n_att = jnp.sum(valid.astype(jnp.int32))
            n_acc = jnp.sum(accept.astype(jnp.int32))
            return cells, e_tot, box, n_att, n_acc

        return swap_substep

    def total_energy(cells, box):
        """Full energy of the bound configuration at box edge ``box`` —
        one all-cells 3^dim-neighbourhood pass (volume proposals)."""
        occ = cells["occ"]
        crd = cells["crd"]
        attr = cells["attr"]
        e = 0.0
        for oi, off in enumerate(offsets):
            crd_n = _roll(crd, off, 1)
            attr_n = _roll(attr, off, 0)
            occ_n = _roll(occ, off, 0)
            r2 = 0.0
            for a in range(dim):
                d = crd_n[a][..., None, :] - crd[a][..., :, None]
                d = d - jnp.round(d)
                r2 = r2 + d * d                    # (..., C, C)
            r2 = r2 * (box * box)
            a_i = attr[..., :, None]
            a_j = attr_n[..., None, :]
            ok = (occ[..., :, None] & occ_n[..., None, :]
                  & (r2 < rcut2_of(a_i, a_j)))
            if oi == centre:
                ok = ok & ~jnp.eye(cap, dtype=bool)
            u = pair_energy(r2, a_i, a_j)
            e = e + jnp.sum(jnp.where(ok, u, 0.0))
        return 0.5 * e

    def make_volume():
        n_particles, pressure = vol

        def vol_substep(cells, e_tot, box, key, dlnv, beta):
            kd, kacc = jax.random.split(key)
            delta = dlnv * jax.random.uniform(kd, (), minval=-1.0,
                                              maxval=1.0)
            box_new = box * jnp.exp(delta / dim)
            # proposal-set restriction: boxes below the grid's validity
            # floor are rejected outright (symmetric — the reverse move is
            # in-range whenever the forward one is)
            in_range = box_new >= grid.box_min
            e_new = total_energy(cells, box_new)
            d_e = e_new - e_tot
            d_v = box ** dim * (jnp.exp(delta) - 1.0)
            dlogp = (-beta * (d_e + pressure * d_v)
                     + (n_particles + 1) * delta)
            u = jax.random.uniform(kacc, ())
            accept = in_range & (jnp.log(u) < dlogp)
            box = jnp.where(accept, box_new, box)
            e_tot = jnp.where(accept, e_new, e_tot)
            return (cells, e_tot, box, jnp.asarray(1, jnp.int32),
                    accept.astype(jnp.int32))

        return vol_substep

    parities = tuple(itertools.product((0, 1), repeat=dim))
    variants = [make_color(p) for p in parities]
    n_colors = len(parities)
    kind_of = [0] * n_colors
    if swap_mode is not None:
        variants += [make_color_swap(p) for p in parities]
        kind_of += [1] * n_colors
    if vol is not None:
        variants.append(make_volume())
        kind_of.append(2)

    def substep(cells, e_tot, box, key, variant, sigma, dlnv, beta):
        """``variant`` indexes the flattened (kind, color) list — a
        substep-shared scalar (see the driver)."""

        def call(f, kind):
            p = dlnv if kind == 2 else sigma
            return lambda args, f=f, p=p: f(args[0], args[1], args[2],
                                            args[3], p, args[4])

        return jax.lax.switch(
            variant,
            [call(f, k) for f, k in zip(variants, kind_of)],
            (cells, e_tot, box, key, beta))

    return substep, total_energy


def cell_total_energy(grid: CellGrid, pair_energy, rcut2_of, pos, attr,
                      box):
    """Reference/TEST helper: full energy of ONE chain's flat
    configuration via the cell decomposition (positions in real units)."""
    s = (pos / box) % 1.0
    cells = bind_cells(grid, s, attr)
    _, tot = _make_substep(grid, pair_energy, rcut2_of)
    return tot(cells, box)


# ---------------------------------------------------------------------------
# Segment driver
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit, static_argnames=("grid", "pair_energy", "rcut2_of",
                              "swap_mode", "proposal", "vol"))
def cell_mc_segment(grid: CellGrid, pair_energy, rcut2_of, pos, attr, beta,
                    energy, sigma, key, n_substeps, w_disp=1.0, w_swap=0.0,
                    swap_mode=None, box=None, proposal="gaussian",
                    vol=None, dlnv=0.0):
    """Run ``n_substeps`` checkerboard substeps on a CHAIN-STACKED state.

    Args:
      grid: static :class:`CellGrid` plan.
      pair_energy / rcut2_of: static model closures on (r2, attr_i, attr_j).
      pos: (M, N, dim) real-space positions; attr: (M, N);
      beta, energy: (M,); box: (M,) per-chain box edges (or scalar).
      sigma: traced proposal width (real units); key: base PRNG key for the
        segment.
      n_substeps: substep count (traced int; each displacement/swap substep
        attempts ~nc^dim / 2^dim moves per chain, a volume substep 1).
      w_disp / w_swap: traced per-substep probabilities of the displacement
        and swap families; the remainder is the volume family.
      swap_mode: None / "species" / "pair" (see :func:`_make_substep`).
      vol: None, or a static ``(n_particles, pressure)`` pair enabling
        volume substeps; ``dlnv`` is the traced ln-V half-width.

    Returns ``(pos', attr', energy', box', attempts, accepts, invalid)``
    with attempts/accepts (M, 3) int32 (columns: displacement, swap,
    volume) and invalid (M,) bool — True when the chain's bind was invalid
    (static cell capacity exceeded, or the chain's box below the grid's
    validity floor).  Invalid chains pass through UNCHANGED (their segment
    is a no-op with zero counters); the caller must surface the flag.
    """
    m, n, dim = pos.shape
    if dim != grid.dim:
        raise ValueError(f"grid is {grid.dim}-D but positions are {dim}-D")
    substep, _ = _make_substep(grid, pair_energy, rcut2_of, swap_mode,
                               proposal, vol)
    if box is None:
        box = jnp.full((m,), grid.box, jnp.float32)
    box = jnp.broadcast_to(jnp.asarray(box, jnp.float32), (m,))

    chain_keys = jax.vmap(jax.random.fold_in, (None, 0))(
        key, jnp.arange(m, dtype=jnp.uint32))
    # random grid origin per bind: a per-chain uniform fractional shift
    # makes the mean anchor-halo coverage position-independent, restoring
    # pi-invariance of the bind+segment composition (module docstring).
    # The shift stream is a DEDICATED double-fold off the segment key (like
    # the 0xC0110 color stream) so it can never alias a substep key
    # fold_in(chain_key, i) at any reachable substep index.
    kshift = jax.random.fold_in(jax.random.fold_in(key, 0x5A1F7), 0x0F5E7)
    shift = jax.vmap(
        lambda c: jax.random.uniform(jax.random.fold_in(kshift, c), (dim,))
    )(jnp.arange(m, dtype=jnp.uint32))                   # (M, dim)
    s = (pos / box[:, None, None] + shift[:, None, :]) % 1.0
    s = jnp.where(s >= 1.0, 0.0, s)    # f32 mod of -eps can return 1.0

    cells = jax.vmap(functools.partial(bind_cells, grid))(s, attr)
    # a chain whose bind is invalid (cell capacity exceeded, or its box
    # below the grid's floor) must NOT run: its segment becomes a no-op and
    # the latched flag surfaces the failure to the host (the orchestrator
    # falls back to the generic path, or Metropolis raises)
    invalid = cells.pop("overflow") | (box < grid.box_min)   # (M,)

    n_kinds = 1 + (swap_mode is not None) + (vol is not None)
    n_colors = 2 ** dim
    w_disp = jnp.asarray(w_disp, jnp.float32)
    w_swap = jnp.asarray(w_swap, jnp.float32)

    def body(i, carry):
        cells, e, bx, att, acc = carry
        # the color/kind draws are SHARED across chains (their own stream
        # off the segment key) so the variant switch stays scalar under
        # vmap — a vectorized switch would execute every branch per substep.
        # Double-fold sentinels keep the stream from aliasing any chain key
        # fold_in(key, c) at reachable chain counts.
        kv = jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(key, 0x7C01), 0xC0110), i)
        color = jax.random.randint(kv, (), 0, n_colors)
        if n_kinds == 1:
            kind = jnp.zeros((), jnp.int32)
        else:
            u = jax.random.uniform(jax.random.fold_in(kv, 1))
            if swap_mode is None:        # disp + volume
                kind = jnp.where(u < w_disp, 0, 2)
            elif vol is None:            # disp + swap
                kind = jnp.where(u < w_disp, 0, 1).astype(jnp.int32)
            else:                        # disp + swap + volume
                kind = jnp.where(u < w_disp, 0,
                                 jnp.where(u < w_disp + w_swap, 1, 2))
        kind = kind.astype(jnp.int32)
        # flattened variant index: displacement colors, swap colors, then
        # the single volume variant at the tail
        vol_variant = n_colors * (2 if swap_mode is not None else 1)
        variant = jnp.where(kind == 2, vol_variant,
                            kind * n_colors + color).astype(jnp.int32)
        keys_i = jax.vmap(jax.random.fold_in, (0, None))(chain_keys, i)
        cells, e, bx, n_att, n_acc = jax.vmap(
            lambda c, ec, b, k, be: substep(c, ec, b, k, variant, sigma,
                                            dlnv, be))(
            cells, e, bx, keys_i, beta)
        koh = jax.nn.one_hot(kind, 3, dtype=jnp.int32)       # (3,)
        att = att + n_att[:, None] * koh[None, :]
        acc = acc + n_acc[:, None] * koh[None, :]
        return cells, e, bx, att, acc

    cells, e, box_out, att, acc = jax.lax.fori_loop(
        0, jnp.asarray(n_substeps, jnp.int32), body,
        (cells, energy, box, jnp.zeros((m, 3), jnp.int32),
         jnp.zeros((m, 3), jnp.int32)))
    s_out, attr_out = jax.vmap(lambda c: unbind_cells(c, n))(cells)
    frac = (s_out - shift[:, None, :]) % 1.0
    frac = jnp.where(frac >= 1.0, 0.0, frac)   # keep pos strictly in [0, box)
    pos_out = frac * box_out[:, None, None]
    # invalid chains: whole segment is a no-op (their bind dropped
    # particles), counters zeroed so the corruption cannot leak
    pos_out = jnp.where(invalid[:, None, None], pos, pos_out)
    attr_out = jnp.where(invalid[:, None], attr, attr_out)
    e = jnp.where(invalid, energy, e)
    box_out = jnp.where(invalid, box, box_out)
    att = jnp.where(invalid[:, None], 0, att)
    acc = jnp.where(invalid[:, None], 0, acc)
    return pos_out, attr_out, e, box_out, att, acc, invalid
