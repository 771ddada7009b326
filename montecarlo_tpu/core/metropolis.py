"""Metropolis–Hastings kernel and driver algorithm.

Rebuild of the reference hot loop (``src/metropolis.jl:176-309``) for JAX
accelerators.  Where the reference runs a scalar ``mc_step!`` per chain in a
Julia closure mapped over OS threads, here one chain's step is a pure function
(:func:`mc_step`), the per-sweep loop is ``lax.scan`` (:func:`mc_sweep`), the
chain axis is ``vmap`` + sharding (handled by the orchestrator/mesh), and
rejection is a ``where``-select — no mutate-and-revert.

RNG design (SURVEY §7 "RNG semantics"): each chain owns a counter-based base
key ``fold_in(seed_key, chain_id)``; per timestep the sweep key is
``fold_in(base, t)``.  This replaces the per-chain ``Xoshiro(seed + c - 1)``
streams (``src/metropolis.jl:262-263``) and is bitwise reproducible for any
chain sharding / host count.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .algorithms import DeviceAlgorithm, ObservableRecorder, SimView
from .moves import Move, MoveDef, tree_select

__all__ = [
    "mc_step",
    "mc_sweep",
    "grouped_mc_step",
    "build_move_groups",
    "Metropolis",
    "callback_acceptance",
    "StoreParameters",
]


def build_move_groups(pool):
    """Group pool moves with identical structure (same ``kind``, aux payload,
    policy class, and flat parameter size) so kernels are traced once per
    group.  Returns ``(groups, group_of, within_of)`` with groups a tuple of
    ``(movedef, member_ids)`` and the two lookup arrays mapping global move
    id → (group index, index within group)."""
    from jax.flatten_util import ravel_pytree
    import numpy as _np

    keys = []
    for m in pool:
        md = m.move
        flat, _ = ravel_pytree(m.params)
        if md.kind:
            keys.append((md.kind, id(md.aux), type(md.policy),
                         int(flat.shape[0])))
        else:
            keys.append(("unique", id(md), id(m)))
    order, members = [], {}
    for k in keys:
        if k not in members:
            members[k] = []
            order.append(k)
    for i, k in enumerate(keys):
        members[k].append(i)
    groups = tuple((pool[members[k][0]].move, tuple(members[k]))
                   for k in order)
    group_of = _np.zeros(len(pool), _np.int32)
    within_of = _np.zeros(len(pool), _np.int32)
    for gi, k in enumerate(order):
        for wi, mid in enumerate(members[k]):
            group_of[mid] = gi
            within_of[mid] = wi
    return groups, group_of, within_of


def mc_step(movedefs: Sequence[MoveDef], params: Sequence, log_weights,
            state, counters, key):
    """One Metropolis–Hastings step on a single chain.

    The 8-stage recipe of ``mc_step!`` + the categorical move selection of
    ``mc_sweep!`` (``src/metropolis.jl:176-212``), fused and purely
    functional:

    sample action -> forward logq -> apply (returns delta log target)
    -> invert -> backward logq -> accept-test in log space -> select.

    Args:
      movedefs: static tuple of :class:`MoveDef` (the pool).
      params: tuple of parameter pytrees, one per move (traced).
      log_weights: precomputed ``log(weight)`` vector, shape ``(K,)``.
      state: single-chain system state pytree.
      counters: ``(K, 2)`` int32 array of (accepted, total) per move.
      key: PRNG key for this step.

    Returns:
      ``(new_state, new_counters)``.
    """
    n_moves = len(movedefs)
    kid, ksample, kaccept = jax.random.split(key, 3)

    def make_branch(k):
        md, p = movedefs[k], params[k]

        def branch(operand):
            st, ks, ka = operand
            action = md.policy.sample(p, ks, st)
            logq_f = md.policy.log_density(p, action, st)
            new_st, dlogp = md.apply(st, action)
            inv = md.invert(action, new_st)
            logq_b = md.policy.log_density(p, inv, new_st)
            log_ratio = dlogp + logq_b - logq_f
            u = jax.random.uniform(ka, dtype=jnp.result_type(log_ratio))
            accept = jnp.log(u) < log_ratio
            return tree_select(accept, new_st, st), accept

        return branch

    if n_moves == 1:
        move_id = jnp.zeros((), jnp.int32)
        new_state, accept = make_branch(0)((state, ksample, kaccept))
    else:
        move_id = jax.random.categorical(kid, log_weights).astype(jnp.int32)
        new_state, accept = jax.lax.switch(
            move_id, [make_branch(k) for k in range(n_moves)],
            (state, ksample, kaccept))

    onehot = jax.nn.one_hot(move_id, n_moves, dtype=counters.dtype)
    inc = jnp.stack([onehot * accept.astype(counters.dtype), onehot], axis=-1)
    return new_state, counters + inc


def grouped_mc_step(groups, group_of, within_of, params, log_weights,
                    n_moves, state, counters, key):
    """Like :func:`mc_step`, but moves with identical structure are grouped:
    selection gathers the chosen move's parameters from a stacked array
    instead of adding a ``lax.switch`` branch per move.

    Under ``vmap`` a K-way switch executes every branch, so a pool of K
    same-structure moves costs K× per step; grouped, it costs 1×.  The
    categorical selection, per-move counters, and acceptance rule are
    identical to :func:`mc_step` (ref ``mc_sweep!``,
    ``src/metropolis.jl:203-212``).

    Args:
      groups: static tuple of ``(movedef, member_move_ids)``.
      group_of / within_of: static int arrays mapping global move id to
        (group index, index within the group's stacked params).
    """
    kid, ksample, kaccept = jax.random.split(key, 3)
    if n_moves == 1:
        move_id = jnp.zeros((), jnp.int32)
    else:
        move_id = jax.random.categorical(kid, log_weights).astype(jnp.int32)
    w = jnp.asarray(within_of)[move_id]

    def make_branch(gi):
        md, members = groups[gi]

        def branch(operand):
            st, ks, ka, w = operand
            if len(members) == 1:
                p = params[members[0]]
            else:
                p_stack = jax.tree_util.tree_map(
                    lambda *xs: jnp.stack(xs),
                    *[params[lid] for lid in members])
                p = jax.tree_util.tree_map(lambda x: x[w], p_stack)
            action = md.policy.sample(p, ks, st)
            logq_f = md.policy.log_density(p, action, st)
            new_st, dlogp = md.apply(st, action)
            inv = md.invert(action, new_st)
            logq_b = md.policy.log_density(p, inv, new_st)
            log_ratio = dlogp + logq_b - logq_f
            u = jax.random.uniform(ka, dtype=jnp.result_type(log_ratio))
            accept = jnp.log(u) < log_ratio
            return tree_select(accept, new_st, st), accept

        return branch

    operand = (state, ksample, kaccept, w)
    if len(groups) == 1:
        new_state, accept = make_branch(0)(operand)
    else:
        g = jnp.asarray(group_of)[move_id]
        new_state, accept = jax.lax.switch(
            g, [make_branch(gi) for gi in range(len(groups))], operand)

    onehot = jax.nn.one_hot(move_id, n_moves, dtype=counters.dtype)
    inc = jnp.stack([onehot * accept.astype(counters.dtype), onehot], axis=-1)
    return new_state, counters + inc


def mc_sweep(movedefs, params, log_weights, state, counters, key,
             mc_steps: int = 1, step_fn=None):
    """``mc_steps`` MH steps on one chain (ref ``mc_sweep!``,
    ``src/metropolis.jl:203-212``) as a ``lax.scan`` over split keys."""
    if step_fn is None:
        step_fn = lambda st, cnt, k: mc_step(
            movedefs, params, log_weights, st, cnt, k)
    if mc_steps == 1:
        return step_fn(state, counters, key)

    keys = jax.random.split(key, mc_steps)

    def body(carry, k):
        st, cnt = carry
        st, cnt = step_fn(st, cnt, k)
        return (st, cnt), None

    (state, counters), _ = jax.lax.scan(body, (state, counters), keys)
    return state, counters


class Metropolis(DeviceAlgorithm):
    """Metropolis driver over all chains (ref ``Metropolis``,
    ``src/metropolis.jl:232-309``).

    Owns the move pool.  The reference deep-copies the pool per chain and then
    aliases policy/parameter objects so a single update affects every chain
    (``src/metropolis.jl:252-260,289``); here parameters are simply replicated
    arrays stored once in device state (``dstate['params']``) — broadcast
    replaces aliasing.

    ``fused`` selects the fast path ('auto'/'off'/'interpret'/'cell');
    ``cell_opts`` tunes the cell-MC plan: ``d_cap`` (anchor halo, real
    units, default 0.45), ``cap_slack`` (capacity as a multiple of mean
    occupancy, default 2.0), ``box_margin`` (NPT compression headroom as a
    box fraction, default 0.15 when the pool carries a volume move).
    """

    state_key = "metropolis"
    #: device-state slot holding this instance's move parameters; the
    #: orchestrator reassigns it (``params_<state_key>``) for a second
    #: params-owning algorithm in the same simulation
    params_key = "params"

    def __init__(self, sim, pool: Sequence[Move] = (), sweepstep: int = 1,
                 seed: int = 1, rng_impl: str = None, fused: str = "auto",
                 cell_opts: dict = None, dependencies=(), **_):
        if not pool:
            raise ValueError("Metropolis requires a non-empty move pool")
        if fused not in ("auto", "off", "interpret", "cell"):
            raise ValueError(
                "fused must be 'auto' (the Triton sweep kernel on a GPU, or "
                "cell MC at large N, when the pool has one), 'off' (always "
                "the generic path), 'interpret' (force the kernel in Pallas "
                "interpret mode — CPU testing), or 'cell' (force the "
                "checkerboard cell-MC path for large-N particle systems)")
        self.fused = fused
        self.pool = tuple(pool)
        self.movedefs = tuple(m.move for m in self.pool)
        self.weights = np.asarray([m.weight for m in self.pool], np.float32)
        if not np.all(self.weights > 0):
            raise ValueError("move weights must be positive")
        self.log_weights = jnp.asarray(
            np.log(self.weights / self.weights.sum()))
        self.sweepstep = int(sweepstep)
        self.seed = int(seed)
        # counter-based PRNG family (ref exposes R::DataType=Xoshiro,
        # src/metropolis.jl:245); JAX impls: threefry2x32 (default), rbg, ...
        self.rng_impl = rng_impl
        self.n_chains = sim.n_chains
        self.n_moves = len(self.pool)
        self.mesh = sim.mesh
        self.groups, self.group_of, self.within_of = build_move_groups(
            self.pool)
        # spatial dimension of particle states (None for non-particle
        # systems): every fused/cell fast path is 2-D only
        pos0 = getattr(sim.chains0, "pos", None)
        self._pos_dim = None if pos0 is None else int(pos0.shape[-1])
        self._sim = sim
        self._cell_disabled = False
        self._plan_cell_mc(sim, cell_opts or {})

    #: kind tag -> (family, role); a pool maps onto the cell path when it
    #: is one displacement move of a single family, optionally + the
    #: matching swap and/or volume move
    _CELL_KINDS = {
        "lj_displacement_2d": ("lj", "disp"),
        "lj_swap": ("lj", "swap"),
        "lj_volume": ("lj", "vol"),
        "poly_displacement_2d": ("poly", "disp"),
        "poly_swap": ("poly", "swap"),
        "poly_volume": ("poly", "vol"),
        "hard_disk_displacement_2d": ("hd", "disp"),
        "hard_disk_volume": ("hd", "vol"),
    }

    def _plan_cell_mc(self, sim, opts):
        """Plan the checkerboard cell-MC decomposition (``ops/cell_mc.py``)
        — the large-N fast path (per-move cost O(3^dim C) instead of O(N),
        ~N/2^dim moves in parallel per substep; 2-D and 3-D).

        ``opts`` (the ``cell_opts`` kwarg) tunes the plan: ``d_cap`` (anchor
        halo, real units), ``cap_slack`` (cell capacity as a multiple of
        mean occupancy), ``box_margin`` (NPT compression headroom as a box
        fraction; default 0.15 when the pool carries a volume move).
        """
        self._cell_plan = None
        self._cell_model = None
        self._cell_plan_error = None

        def unsupported(reason):
            # an EXPLICIT fused='cell' request must fail loudly instead of
            # silently degrading to the ~100x-slower generic path
            self._cell_plan_error = reason
            if self.fused == "cell":
                raise ValueError(f"fused='cell' requested but {reason}")

        if self._pos_dim not in (None, 2, 3):
            return unsupported(
                f"the cell decomposition is 2-D/3-D only (state has "
                f"{self._pos_dim}-D positions)")
        kinds = tuple(m.move.kind for m in self.pool)
        if not kinds or any(k not in self._CELL_KINDS for k in kinds):
            return unsupported(
                f"the pool kinds {kinds} have no cell-MC mapping (need a "
                f"single LJ/poly/hard-disk displacement move, optionally + "
                f"the matching swap and/or volume move)")
        families = {self._CELL_KINDS[k][0] for k in kinds}
        roles = [self._CELL_KINDS[k][1] for k in kinds]
        if len(families) != 1 or roles.count("disp") != 1 \
                or roles.count("swap") > 1 or roles.count("vol") > 1:
            return unsupported(
                f"the pool kinds {kinds} have no cell-MC mapping (need "
                f"one family with one displacement move, at most one swap "
                f"and one volume move)")
        family = families.pop()
        disp_idx = roles.index("disp")
        swap_idx = roles.index("swap") if "swap" in roles else None
        vol_idx = roles.index("vol") if "vol" in roles else None
        swap_mode = {"lj": "species", "poly": "pair", "hd": None}[family] \
            if swap_idx is not None else None
        proposal = "square" if family == "hd" else "gaussian"
        if swap_idx is not None and (
                self.pool[disp_idx].move.aux != self.pool[swap_idx].move.aux):
            return unsupported(
                "the displacement and swap moves carry different "
                "interaction tables (no shared cell geometry)")
        pressure = None
        if vol_idx is not None:
            vaux = self.pool[vol_idx].move.aux
            if (not isinstance(vaux, tuple) or len(vaux) != 2
                    or vaux[0] != self.pool[disp_idx].move.aux):
                return unsupported(
                    "the volume move carries a different interaction table "
                    "than the displacement move (no shared cell geometry)")
            pressure = float(vaux[1])
        try:
            state0 = sim.chains0
            box0 = float(np.asarray(state0.box).ravel()[0])
            n_particles = int(state0.pos.shape[-2])
            if family == "lj":
                from ..models.lennard_jones import cell_closures
                pe, rc2, rcut_max = cell_closures(
                    self.pool[disp_idx].move.aux)
            elif family == "poly":
                from ..models.polydisperse import cell_closures
                pe, rc2, rcut_max = cell_closures(
                    self.pool[disp_idx].move.aux)
            else:
                from ..models.hard_disks import cell_closures
                pe, rc2, rcut_max = cell_closures()
            from ..ops.cell_mc import plan_grid
            # fixed 0.45 halo default: measured better than sizing it to
            # ~3 sigma (a tighter halo buys a slightly finer grid but
            # loses more to anchor rejections — acc 0.17 -> 0.14 at
            # sigma 0.08, N=4096)
            d_cap = float(opts.get("d_cap", 0.45))
            cap_slack = float(opts.get("cap_slack", 2.0))
            box_margin = float(opts.get(
                "box_margin", 0.15 if vol_idx is not None else 0.0))
            dim = self._pos_dim
            plan0 = plan_grid(n_particles, box0, rcut_max, d_cap=d_cap,
                              cap_slack=cap_slack, dim=dim,
                              box_margin=box_margin)
            # quantile-style capacity: measure the actual max per-cell
            # occupancy of the initial configuration (a mean multiple
            # under-sizes clustered states — ADVICE r4), with NPT
            # compression headroom when volume moves can shrink the box
            max_occ = _max_cell_occupancy(state0, plan0.nc, dim)
            if vol_idx is not None:
                max_occ = int(np.ceil(
                    max_occ * (box0 / plan0.box_min) ** dim))
            self._cell_plan = plan_grid(
                n_particles, box0, rcut_max, d_cap=d_cap,
                cap_slack=cap_slack, dim=dim, box_margin=box_margin,
                max_occupancy=max_occ)
            self._cell_model = (pe, rc2, family, swap_mode, disp_idx,
                                swap_idx, vol_idx, pressure, proposal)
            self._cell_n = n_particles
        except (ValueError, AttributeError) as e:
            self._cell_plan = None  # box too small / no geometry: row path
            self._cell_plan_error = str(e)
            if self.fused == "cell":
                raise ValueError(
                    f"fused='cell' requested but the cell decomposition "
                    f"cannot be planned: {e}") from e
            return
        self._cell_plan_error = None

    def disable_cell_path(self):
        """Orchestrator fallback hook: permanently drop to the generic path
        (called when an auto-selected cell bind overflows mid-run)."""
        self._cell_disabled = True
        self._cell_plan_error = (
            "disabled mid-run: a cell bind exceeded the planned capacity; "
            "fell back to the generic path")

    @property
    def _use_cell(self) -> bool:
        if self._cell_plan is None or self._cell_disabled:
            return False
        if self.fused == "cell":
            return True   # explicit opt-in (validate_state surfaces misuse)
        # auto: the row kernel's O(N) per-move cost overtakes the cell
        # path's O(3^dim C) around N ~ 2k at liquid densities.  Volume
        # moves are fine — the fractional-coordinate grid accepts any
        # per-chain box above the plan's validity floor.
        return self.fused == "auto" and self._cell_n >= 2048

    # -- device-state slice ------------------------------------------------
    class CellBindInvalid(RuntimeError):
        """An auto-selected cell bind overflowed; the orchestrator catches
        this at the next host sync point and falls back to the generic
        path (the offending segments were skipped as no-ops)."""

        def __init__(self, alg):
            self.alg = alg
            super().__init__("cell-MC bind became invalid during the run")

    def init_state(self, sim):
        base = (jax.random.key(self.seed, impl=self.rng_impl)
                if self.rng_impl else jax.random.key(self.seed))
        chain_ids = jnp.arange(self.n_chains, dtype=jnp.uint32)
        keys = jax.vmap(jax.random.fold_in, (None, 0))(base, chain_ids)
        counters = jnp.zeros((self.n_chains, self.n_moves, 2), jnp.int32)
        slc = {"keys": keys, "counters": counters}
        if self._cell_plan is not None:
            # latched flag: a cell bind became invalid (capacity exceeded
            # or box below the grid's validity floor); checked on host at
            # every sync point.  cell_debt carries the fractional-substep
            # credit so fine recorder strides don't round every segment up
            # to a whole substep (ADVICE r4).
            slc["cell_overflow"] = jnp.zeros((), bool)
            slc["cell_debt"] = jnp.zeros((), jnp.float32)
        return slc

    def validate_state(self, dstate):
        """Host-side sanity check, called at every host sync point: surface
        a latched invalid-cell-bind flag (the affected segments were
        skipped as no-ops, so the state is uncorrupted but under-sampled).
        Auto-selected runs raise :class:`CellBindInvalid`, which the
        orchestrator catches to fall back to the generic path; an explicit
        ``fused='cell'`` request fails loudly instead."""
        if self._cell_disabled:
            return
        slc = dstate.get(self.state_key, {})
        flag = slc.get("cell_overflow")
        if flag is not None and bool(jax.device_get(flag)):
            if self.fused != "cell":
                raise Metropolis.CellBindInvalid(self)
            raise RuntimeError(
                "cell-MC bind became invalid during the run: a cell "
                "exceeded its static capacity, or a chain's box shrank "
                "below the planned grid's validity floor.  The affected "
                "segments were skipped (no-op, zero counters).  Enlarge "
                "cell_opts={'cap_slack': ...} / {'box_margin': ...}, or "
                "use fused='off'.")

    def init_params(self):
        """Initial replicated move parameters (tuple, one pytree per move)."""
        return tuple(
            jax.tree_util.tree_map(jnp.asarray, m.params) for m in self.pool)

    # -- compiled step -----------------------------------------------------
    def step(self, dstate, t):
        slc = dstate[self.state_key]
        params = dstate[self.params_key]
        step_keys = jax.vmap(jax.random.fold_in, (0, None))(
            slc["keys"], t.astype(jnp.uint32))

        def step_fn(st, cnt, k):
            return grouped_mc_step(self.groups, self.group_of, self.within_of,
                                   params, self.log_weights, self.n_moves,
                                   st, cnt, k)

        def one_chain(st, cnt, k):
            return mc_sweep(self.movedefs, params, self.log_weights, st, cnt,
                            k, self.sweepstep, step_fn=step_fn)

        sys, counters = jax.vmap(one_chain)(
            dstate["sys"], slc["counters"], step_keys)
        return {**dstate, "sys": sys,
                self.state_key: {**slc, "counters": counters}}

    # -- fused fast paths ---------------------------------------------------
    _FUSED_KINDS = ("gaussian_displacement_1d",)

    @property
    def supports_fused(self) -> bool:
        """True when the pool has a segment-level fast path: the checkerboard
        cell MC (plain XLA, any backend) or the Triton Gaussian sweep kernel
        (``ops/fused_sweep.py``) for a single 1-D Gaussian displacement move.
        The kernel is auto-selected on a GPU backend; ``fused='off'`` opts
        out, ``fused='interpret'`` runs it in Pallas interpret mode on any
        backend (CPU tests).  Every other pool runs the generic path."""
        if self.fused == "off":
            return False
        if self.fused == "cell":
            return self._cell_plan is not None
        if self._use_cell:
            # cell MC is plain XLA — backend-agnostic, so 'auto' at large N
            # engages it on CPU too (keeps supports_fused consistent with
            # the _use_cell introspection on every backend)
            return True
        if self.fused != "interpret" and jax.default_backend() != "gpu":
            return False
        return (self.n_moves == 1
                and self.pool[0].move.kind in self._FUSED_KINDS)

    def fused_advance(self, dstate, n_steps):
        """Advance all chains ``n_steps * sweepstep`` MH steps in one
        segment: the cell-MC path, or one launch of the Gaussian sweep
        kernel, which keeps each chain in a register for the segment.

        Counters/cached-energy semantics match :meth:`step`; the kernel's
        random stream is a counter-based hash of (seed, step, chain), so
        individual trajectories differ from the threefry path while the
        sampled distribution is identical.
        """
        slc = dstate[self.state_key]
        sys = dstate["sys"]
        params = dstate[self.params_key]
        t0 = dstate["t"]
        total = (n_steps * self.sweepstep).astype(jnp.int32)
        # per-step seeding off the absolute micro-step index keeps results
        # invariant to how recorder schedules slice the run into segments
        micro_t0 = (t0 * self.sweepstep).astype(jnp.int32)

        if self._use_cell:           # checkerboard cell MC (large N)
            from ..ops.cell_mc import cell_mc_segment
            plan = self._cell_plan
            (pe, rc2, family, swap_mode, disp_idx, swap_idx, vol_idx,
             pressure, proposal) = self._cell_model
            sigma = jax.tree_util.tree_leaves(params[disp_idx])[0]
            wsum = float(self.weights.sum())
            w_d = float(self.weights[disp_idx]) / wsum
            w_s = (float(self.weights[swap_idx]) / wsum
                   if swap_idx is not None else 0.0)
            w_v = (float(self.weights[vol_idx]) / wsum
                   if vol_idx is not None else 0.0)
            # substep accounting: a displacement/swap substep delivers
            # ~A attempts, a volume substep 1 per chain.  z = substeps per
            # requested MC step; the fractional remainder is carried in
            # cell_debt so fine recorder strides don't round every segment
            # up to a whole substep (ADVICE r4).
            a_att = (plan.nc ** plan.dim) // (2 ** plan.dim)
            z = (w_d + w_s) / a_att + w_v
            want = total.astype(jnp.float32) * z + slc["cell_debt"]
            substeps = jnp.floor(want).astype(jnp.int32)
            new_debt = want - substeps.astype(jnp.float32)
            # per-substep kind probabilities (attempt-rate matched)
            p_d = (w_d / a_att) / z
            p_s = (w_s / a_att) / z
            if vol_idx is not None:
                dlnv = params[vol_idx]["dlnv"]
                vol = (self._cell_n, pressure)
            else:
                dlnv, vol = 0.0, None
            base = jax.random.fold_in(jax.random.key(self.seed),
                                      micro_t0.astype(jnp.uint32))
            if family == "lj":
                attr = sys.species.astype(jnp.float32)
            elif family == "poly":
                attr = sys.diam
            else:                    # hard disks: no attributes, no energy
                attr = jnp.zeros(sys.pos.shape[:-1], jnp.float32)
            n_chains = sys.pos.shape[0]
            beta_in = (sys.beta if hasattr(sys, "beta")
                       else jnp.ones((n_chains,), jnp.float32))
            energy_in = (sys.energy if hasattr(sys, "energy")
                         else jnp.zeros((n_chains,), jnp.float32))
            pos, attr_out, energy, box_out, att, acc, ovf = cell_mc_segment(
                plan, pe, rc2, sys.pos, attr, beta_in, energy_in,
                sigma, base, substeps, w_disp=p_d, w_swap=p_s,
                swap_mode=swap_mode, box=sys.box, proposal=proposal,
                vol=vol, dlnv=dlnv)
            if family == "lj":
                new_sys = dataclasses.replace(
                    sys, pos=pos, species=attr_out.astype(sys.species.dtype),
                    energy=energy, box=box_out)
            elif family == "poly":
                new_sys = dataclasses.replace(
                    sys, pos=pos, diam=attr_out, energy=energy, box=box_out)
            else:
                new_sys = dataclasses.replace(sys, pos=pos, box=box_out)
            inc = jnp.zeros_like(slc["counters"])
            inc = inc.at[:, disp_idx, 0].add(acc[:, 0])
            inc = inc.at[:, disp_idx, 1].add(att[:, 0])
            if swap_idx is not None:
                inc = inc.at[:, swap_idx, 0].add(acc[:, 1])
                inc = inc.at[:, swap_idx, 1].add(att[:, 1])
            if vol_idx is not None:
                inc = inc.at[:, vol_idx, 0].add(acc[:, 2])
                inc = inc.at[:, vol_idx, 1].add(att[:, 2])
            out_slc = {**slc, "counters": slc["counters"] + inc,
                       "cell_debt": new_debt}
            if "cell_overflow" in slc:
                out_slc["cell_overflow"] = slc["cell_overflow"] | jnp.any(ovf)
            return {**dstate, "sys": new_sys,
                    "t": (t0 + n_steps).astype(jnp.int32),
                    self.state_key: out_slc}

        from ..ops.fused_sweep import (fused_gaussian_sweep,
                                       sharded_gaussian_sweep)
        sigma = jax.tree_util.tree_leaves(params[0])[0]
        potential = self.pool[0].move.aux
        seed = jnp.int32(self.seed)
        interp = self.fused == "interpret"
        if self.mesh is not None:
            x, e, acc = sharded_gaussian_sweep(
                self.mesh, self.mesh.axis_names[0], sys.x, sys.beta, sigma,
                seed, micro_t0, total, potential=potential,
                interpret=interp)
        else:
            x, e, acc = fused_gaussian_sweep(
                sys.x, sys.beta, sigma, seed, micro_t0, total,
                potential=potential, interpret=interp)
        new_sys = dataclasses.replace(sys, x=x, e=e)
        counters = slc["counters"] + jnp.stack(
            [acc, jnp.broadcast_to(total, acc.shape)], axis=-1)[:, None, :]
        return {**dstate, "sys": new_sys, "t": (t0 + n_steps).astype(jnp.int32),
                self.state_key: {**slc, "counters": counters}}

    # -- summary -----------------------------------------------------------
    def write_summary(self, io, scheduler):
        from .algorithms import _n_calls
        io.write("\tMetropolis\n")
        io.write(f"\t\tCalls: {_n_calls(scheduler)}\n")
        io.write(f"\t\tMC steps per simulation step: {self.sweepstep}\n")
        io.write(f"\t\tSeed: {self.seed}\n")
        io.write(f"\t\tParallel: {jax.device_count() > 1}\n")
        io.write(f"\t\tDevices: {jax.device_count()}\n")
        if self._use_cell:
            io.write(f"\t\tCell MC: enabled ({self._cell_plan!r})\n")
        elif self._pos_dim is not None and self._cell_plan_error is not None:
            # particle system without a cell plan: record why, so a user on
            # the generic fallback can see what kept auto-cell off
            io.write(f"\t\tCell MC: unavailable — "
                     f"{self._cell_plan_error}\n")
        io.write("\t\tMoves:\n")
        for k, move in enumerate(self.pool):
            io.write(f"\t\t\tMove {k + 1}:\n")
            io.write(f"\t\t\t\tAction: {move.move.name}\n")
            io.write(f"\t\t\t\tPolicy: {type(move.move.policy).__name__}\n")
            io.write(f"\t\t\t\tParameters: {_fmt_params(move.params)}\n")
            io.write(f"\t\t\t\tWeight: {move.weight}\n")


def _fmt_params(params) -> str:
    flat = np.concatenate(
        [np.ravel(np.asarray(x)) for x in jax.tree_util.tree_leaves(params)])
    return "[" + ", ".join(repr(float(v)) for v in flat) + "]"


def _max_cell_occupancy(state0, nc: int, dim: int,
                        max_chains: int = 64) -> int:
    """Max per-cell particle count of the initial configuration (host-side
    numpy, sampled over at most ``max_chains`` chains) — sizes the cell
    capacity from an observed quantile instead of the mean."""
    # slice BEFORE materialising: pulling all M chains host-side at plan
    # time costs seconds over a slow host link at flagship chain counts
    pos = np.asarray(state0.pos[:max_chains])
    box = np.asarray(state0.box)[:max_chains].reshape(-1, 1, 1)
    ci = np.clip((pos / box * nc).astype(np.int64), 0, nc - 1)
    cid = ci[..., 0]
    for a in range(1, dim):
        cid = cid * nc + ci[..., a]
    m = pos.shape[0]
    cid = cid + nc ** dim * np.arange(m)[:, None]
    return int(np.bincount(cid.ravel()).max())


def callback_acceptance(view: SimView):
    """Mean acceptance rate over chains and moves of EVERY Metropolis
    instance (ref ``callback_acceptance``, ``src/metropolis.jl:319-321``,
    which averages over all Metropolis algorithms in the list).  Entries
    with zero attempts (e.g. the t=0 ``store_first`` row) are excluded
    from the mean instead of producing 0/0 = nan."""
    num = jnp.zeros((), jnp.float32)
    den = jnp.zeros((), jnp.float32)
    for key in view.state:
        if not key.startswith("metropolis"):
            continue
        slc = view.state[key]
        if not isinstance(slc, dict) or "counters" not in slc:
            continue
        counters = slc["counters"]                       # (M, K, 2)
        acc = counters[..., 0].astype(jnp.float32)
        tot = counters[..., 1].astype(jnp.float32)
        valid = tot > 0
        num = num + jnp.sum(jnp.where(valid, acc / jnp.maximum(tot, 1.0),
                                      0.0))
        den = den + jnp.sum(valid.astype(jnp.float32))
    return num / jnp.maximum(den, 1.0)


class StoreParameters(ObservableRecorder):
    """Snapshot shared move parameters to ``parameters/<k>/parameters.dat``
    (ref ``StoreParameters``, ``src/metropolis.jl:380-450``)."""

    def __init__(self, sim, dependencies=(), ids=None, store_first: bool = True,
                 store_last: bool = False, **_):
        deps = [d for d in dependencies if isinstance(d, Metropolis)]
        if len(deps) != 1:
            raise ValueError(
                "StoreParameters requires a single Metropolis dependency "
                "(with two samplers, disambiguate with an index: "
                "dependencies=(0,))")
        self.metropolis = deps[0]
        n_moves = self.metropolis.n_moves
        self.ids = list(range(n_moves)) if ids is None else list(ids)
        self.store_first = store_first
        self.store_last = store_last
        self._root = sim.path
        self.dirs = []
        self.paths = []
        self.files = []

    def _resolve_paths(self):
        # The primary sampler keeps the reference layout
        # ``parameters/<k>/parameters.dat`` (``src/metropolis.jl:425-429``);
        # additional samplers are namespaced by their (uniquified) state key
        # so two StoreParameters never write the same file.  Deferred to
        # initialise: state keys are final only after Simulation construction.
        base = os.path.join(self._root, "parameters")
        if self.metropolis.params_key != "params":
            base = os.path.join(base, self.metropolis.state_key)
        self.dirs = [os.path.join(base, str(k + 1)) for k in self.ids]
        self.paths = [os.path.join(d, "parameters.dat") for d in self.dirs]

    def initialise(self, sim):
        from .algorithms import _io_host
        self._resolve_paths()
        if not _io_host():
            return  # multi-host: only the IO host touches the filesystem
        if sim.verbose:
            print("Opening parameter files...")
        for d in self.dirs:
            os.makedirs(d, exist_ok=True)
        self.files = [open(p, "w") for p in self.paths]

    def observable(self, view: SimView):
        params = view.state[self.metropolis.params_key]
        return tuple(params[k] for k in self.ids)

    def write(self, sim, t, value):
        for f, p in zip(self.files, value):
            f.write(f"{t} {_fmt_params(p)}\n")
            f.flush()

    def finalise(self, sim):
        if sim.verbose:
            print("Closing parameter files...")
        for f in self.files:
            f.close()
        self.files = []
