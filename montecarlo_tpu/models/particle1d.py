"""1-D particle in an external potential.

Rebuild of the reference example system
(``example/particle_1d/particle_1d.jl``): state carries position ``x``,
inverse temperature ``beta`` and the *cached* potential energy ``e`` (the
functional analogue of ``Particle.e``, ``particle_1d.jl:9-16``), so the
Displacement move's delta-log-target is computed from cached energies —
the ``perform_action_cached!`` trick as data instead of control flow.

Provides the harmonic oscillator and double-well potentials used by the
reference tests/examples, the Gaussian Displacement move with analytic
log-density (``particle_1d.jl:26-59``), and the energy callback
(``particle_1d.jl:68-70``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..core.moves import Move, MoveDef, Policy
from ..core.system import SystemDef

__all__ = [
    "Particle1DState",
    "harmonic",
    "double_well",
    "make_system",
    "init_chains",
    "StandardGaussian",
    "displacement_move",
    "LangevinGaussian",
    "mala_move",
    "callback_energy",
    "zigzag_model",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Particle1DState:
    """Single-chain state (chain axis added by ``vmap``/``stack_chains``)."""
    x: jax.Array      # position
    beta: jax.Array   # inverse temperature
    e: jax.Array      # cached potential energy  (ref Particle.e)


def harmonic(x):
    """U(x) = x^2 (ref ``potential(x) = x^2`` in the harmonic example)."""
    return x * x


def double_well(x, a=1.0, h=1.0):
    """U(x) = h * (x^2 - a^2)^2 / a^4 — double well with minima at ±a."""
    d = x * x - a * a
    return h * d * d / (a ** 4)


def make_system(potential=harmonic) -> SystemDef:
    """System descriptor.  Log target = -beta * e from the cached energy
    (ref ``unnormalised_log_target_density``, ``particle_1d.jl:20-22``)."""

    def log_target(state: Particle1DState):
        return -state.e * state.beta

    def frame(state: Particle1DState):
        return state.x

    def format_frame(t, x):
        # ref custom store_trajectory: "t x" (particle_1d.jl:63-66)
        return f"{t} {float(x)!r}"

    def parse_frame(line: str):
        t_str, x_str = line.split()
        return int(t_str), float(x_str)

    return SystemDef(name="Particle1D", log_target=log_target, frame=frame,
                     format_frame=format_frame, parse_frame=parse_frame)


def init_chains(n_chains: int, beta: float, seed: int = 42,
                potential=harmonic, dtype=jnp.float32) -> Particle1DState:
    """Chain-stacked initial state with x0 ~ U[-2, 2) (matching the
    reference scripts' ``4rand(rng) - 2`` init)."""
    key = jax.random.key(seed)
    x = 4.0 * jax.random.uniform(key, (n_chains,), dtype=dtype) - 2.0
    return Particle1DState(
        x=x,
        beta=jnp.full((n_chains,), beta, dtype),
        e=potential(x),
    )


class StandardGaussian(Policy):
    """Zero-mean Gaussian over displacements, parameter ``sigma``
    (ref ``StandardGaussian`` policy, ``particle_1d.jl:48-59``)."""

    def sample(self, params, key, state):
        sigma = params["sigma"]
        return sigma * jax.random.normal(key, dtype=jnp.result_type(sigma))

    def log_density(self, params, action, state):
        sigma = params["sigma"]
        return (-(action * action) / (2.0 * sigma * sigma)
                - 0.5 * jnp.log(2.0 * jnp.pi * sigma * sigma))


def displacement_move(sigma: float, weight: float = 1.0,
                      potential=harmonic) -> Move:
    """Gaussian displacement move (ref ``Displacement`` action +
    ``perform_action!``/``invert_action!``/``reward``,
    ``particle_1d.jl:26-44``)."""

    def apply(state: Particle1DState, delta):
        xn = state.x + delta
        en = potential(xn)
        dlogp = -(en - state.e) * state.beta
        return dataclasses.replace(state, x=xn, e=en), dlogp

    def invert(delta, new_state):
        return -delta

    def reward(delta, new_state):
        return delta * delta

    md = MoveDef(name="Displacement", policy=StandardGaussian(),
                 apply=apply, invert=invert, reward=reward,
                 kind="gaussian_displacement_1d", aux=potential)
    return Move(move=md, params={"sigma": jnp.asarray(sigma, jnp.float32)},
                weight=weight)


class LangevinGaussian(Policy):
    """Gradient-informed (MALA) displacement proposal.

    The capability the reference's AD layer never reaches: using the
    *gradient of the target* inside the proposal itself.  The drift is one
    Euler–Maruyama step of the overdamped Langevin dynamics,

        delta ~ N( eps * grad log pi(x),  2 eps )
              = N( -eps * beta * U'(x),  2 eps ),

    with ``U'`` obtained by ``jax.grad`` of the potential — traced once and
    fused into the proposal kernel by XLA.  The proposal is ASYMMETRIC: the
    backward density is evaluated at the proposed state with the inverted
    action, which is exactly what the generic MH kernel does
    (``core/metropolis.py:mc_step`` stages 4-5, mirroring the reference's
    invert-then-backward-logq recipe, ``src/metropolis.jl:176-190``), so MALA
    drops in as a plain :class:`~montecarlo_tpu.core.moves.Policy` with no
    kernel changes.

    Parameter ``step`` (= eps) is learnable by PGMC like any other policy
    parameter — ``jax.value_and_grad`` differentiates straight through the
    drift term.
    """

    def __init__(self, potential=harmonic):
        self.grad_u = jax.grad(potential)

    def _drift(self, params, state):
        return -params["step"] * state.beta * self.grad_u(state.x)

    def sample(self, params, key, state):
        eps = params["step"]
        noise = jnp.sqrt(2.0 * eps) * jax.random.normal(
            key, dtype=jnp.result_type(eps))
        return self._drift(params, state) + noise

    def log_density(self, params, action, state):
        eps = params["step"]
        d = action - self._drift(params, state)
        return (-(d * d) / (4.0 * eps)
                - 0.5 * jnp.log(4.0 * jnp.pi * eps))


def mala_move(step: float, weight: float = 1.0, potential=harmonic) -> Move:
    """Metropolis-adjusted Langevin move.

    Same apply/invert/reward semantics as :func:`displacement_move` (the
    action is still "shift x by delta"); only the proposal differs.  Small
    ``step`` -> acceptance near 1 (the proposal approaches the exact
    diffusion); large ``step`` trades acceptance for stride.
    """
    if step <= 0:
        raise ValueError(f"MALA step size must be positive, got {step}")

    def apply(state: Particle1DState, delta):
        xn = state.x + delta
        en = potential(xn)
        dlogp = -(en - state.e) * state.beta
        return dataclasses.replace(state, x=xn, e=en), dlogp

    def invert(delta, new_state):
        return -delta

    def reward(delta, new_state):
        return delta * delta

    md = MoveDef(name="LangevinDisplacement",
                 policy=LangevinGaussian(potential),
                 apply=apply, invert=invert, reward=reward,
                 kind="mala_displacement_1d", aux=potential)
    return Move(move=md, params={"step": jnp.asarray(step, jnp.float32)},
                weight=weight)


def callback_energy(view):
    """Mean cached energy over chains (ref ``callback_energy``,
    ``particle_1d.jl:68-70``)."""
    return jnp.mean(view.sys.e)


# ---------------------------------------------------------------------------
# Event-chain (zig-zag) sampler for the harmonic target
# ---------------------------------------------------------------------------

def zigzag_model():
    """1-D event-chain model for the harmonic target exp(-beta x^2) —
    the zig-zag process, with **closed-form** event times.

    The lifted state is a velocity v in {-1, +1}; x moves ballistically and
    v flips at events drawn from the hazard rate
    ``lambda(t) = beta * max(0, d/dt U(x + v t))`` (U = x^2).  Integrating
    the hazard: downhill motion (x v < 0) is event-free until x crosses 0;
    uphill from coordinate w = max(x v, 0), the cumulative hazard is
    ``beta ((w + s)^2 - w^2)``, so with E ~ Exp(1) the event time is

        t* = -min(x v, 0) + sqrt(w^2 + E / beta) - w.

    Every move is accepted; the sampler is non-reversible (v breaks detailed
    balance) yet leaves exp(-beta x^2) invariant — the 1-D essence of
    event-chain MC (ref capability claim ``README.md:27``).

    ECMC expectations are **time averages**: the returned statistics
    accumulate the exact trajectory integrals
    ``t``, ``sx = int x dt``, ``sx2 = int x^2 dt``, ``sx4 = int x^4 dt``
    (polynomial in closed form), so moments need no discretisation.
    """
    from ..core.ecmc import EventChainModel

    def init_lift(state, key):
        v = jnp.where(jax.random.bernoulli(key), 1.0, -1.0).astype(
            jnp.result_type(state.x))
        return {"v": v}

    def event_step(state, lift, key):
        x, beta, v = state.x, state.beta, lift["v"]
        u = jax.random.uniform(key, (), jnp.result_type(x),
                               minval=jnp.finfo(jnp.float32).tiny)
        exp_draw = -jnp.log(u)                      # E ~ Exp(1)
        xv = x * v
        w = jnp.maximum(xv, 0.0)
        t = -jnp.minimum(xv, 0.0) + jnp.sqrt(w * w + exp_draw / beta) - w

        def poly_int(k):                            # int_0^t (x + v s)^k ds
            return ((x + v * t) ** (k + 1) - x ** (k + 1)) / ((k + 1) * v)

        stats = {"t": t, "sx": poly_int(1), "sx2": poly_int(2),
                 "sx4": poly_int(4)}
        xn = x + v * t
        new_state = dataclasses.replace(state, x=xn, e=xn * xn)
        return new_state, {"v": -v}, stats

    return EventChainModel(init_lift=init_lift, event_step=event_step,
                           name="ZigZagHarmonic1D")
