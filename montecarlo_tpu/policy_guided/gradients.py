"""PGMC gradient estimation kernel.

Rebuild of ``src/PolicyGuided/gradients.jl``.  The reference
supports three AD backends (ForwardDiff/Enzyme/Zygote) behind
``withgrad_log_proposal_density!`` (``gradients.jl:28``, ``ext/*.jl``); here a
single backend — ``jax.value_and_grad`` through the policy log-density —
serves both directions, with policies free to provide analytic gradients via
``jax.custom_jvp``/``custom_vjp`` as the escape hatch.

Parameters are handled as flat vectors (``ravel_pytree``) so the Fisher-metric
outer product ``g`` (``gradients.jl:107``) is a plain ``(P, P)`` matrix and
the :class:`GradientData` monoid sums with ``tree_map``/``psum``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from ..core.moves import MoveDef

__all__ = [
    "GradientData",
    "init_gradient_data",
    "add",
    "average",
    "pgmc_estimate",
    "sample_gradient_data",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GradientData:
    """Monoid carried by the estimator (ref ``GradientData``,
    ``src/PolicyGuided/gradients.jl:41-85``)."""
    j: jax.Array                  # objective estimate (scalar)
    grad_j: jax.Array             # ∇θ j, shape (P,)
    grad_logq_forward: jax.Array  # ∇θ log q(forward), shape (P,)
    g: jax.Array                  # Fisher-metric outer product, (P, P)
    n: jax.Array                  # sample count (i32 scalar)


def init_gradient_data(n_params: int, dtype=jnp.float32) -> GradientData:
    """Zero accumulator (ref ``initialise_gradient_data``,
    ``gradients.jl:54``)."""
    return GradientData(
        j=jnp.zeros((), dtype),
        grad_j=jnp.zeros((n_params,), dtype),
        grad_logq_forward=jnp.zeros((n_params,), dtype),
        g=jnp.zeros((n_params, n_params), dtype),
        n=jnp.zeros((), jnp.int32),
    )


def add(a: GradientData, b: GradientData) -> GradientData:
    """Monoid sum (ref ``Base.:+``, ``gradients.jl:68``)."""
    return jax.tree_util.tree_map(lambda x, y: x + y, a, b)


def average(gd: GradientData) -> GradientData:
    """Divide the accumulated sums by the sample count
    (ref ``average``, ``gradients.jl:83``)."""
    n = gd.n.astype(gd.j.dtype)
    return GradientData(j=gd.j / n, grad_j=gd.grad_j / n,
                        grad_logq_forward=gd.grad_logq_forward / n,
                        g=gd.g / n, n=gd.n)


def _withgrad_log_density(policy, flat_params, unravel, action, state):
    """(logq, ∇θ logq) — the single dispatch point that replaces the
    reference's AD-backend plugin layer (``withgrad_log_proposal_density!``,
    ``src/PolicyGuided/gradients.jl:28`` + ``ext/EnzymeExt.jl`` /
    ``ext/ZygoteExt.jl``).

    Default backend is ``jax.value_and_grad``; a policy may supply the
    analytic escape hatch ``grad_log_density(params, action, state) ->
    params-shaped pytree`` to bypass AD entirely (SURVEY §7.6).
    """
    grad_fn = getattr(policy, "grad_log_density", None)
    if grad_fn is not None:
        params = unravel(flat_params)
        logq = policy.log_density(params, action, state)
        grad_tree = grad_fn(params, action, state)
        flat_grad, _ = ravel_pytree(grad_tree)
        return logq, flat_grad
    return jax.value_and_grad(
        lambda fp: policy.log_density(unravel(fp), action, state))(flat_params)


def pgmc_estimate(movedef: MoveDef, flat_params, unravel, state,
                  action) -> GradientData:
    """Off-policy PGMC probe for one sampled action (ref ``pgmc_estimate``,
    ``gradients.jl:93-109``).

    The reference performs the action, measures, then *always reverts*
    (``gradients.jl:103``) — the chain is not advanced.  Purely functionally
    we simply never return the new state.
    """
    policy = movedef.policy
    logq_f, glogq_f = _withgrad_log_density(policy, flat_params, unravel,
                                            action, state)
    new_state, dlogp = movedef.apply(state, action)
    if movedef.reward is None:
        raise ValueError(f"move {movedef.name} defines no reward; "
                         "required for policy-guided adaptation")
    r = movedef.reward(action, new_state)
    inv = movedef.invert(action, new_state)
    logq_b, glogq_b = _withgrad_log_density(policy, flat_params, unravel,
                                            inv, new_state)

    log_ratio = dlogp + logq_b - logq_f
    alpha = jnp.exp(jnp.minimum(log_ratio, 0.0))
    j = r * alpha
    # ref gradients.jl:106 — use the forward gradient iff α == 1
    grad_j = j * jnp.where(log_ratio >= 0.0, glogq_f, glogq_b)
    g = jnp.outer(glogq_f, glogq_f)
    return GradientData(j=j, grad_j=grad_j, grad_logq_forward=glogq_f, g=g,
                        n=jnp.ones((), jnp.int32))


def sample_gradient_data(movedef: MoveDef, params, state,
                         key) -> GradientData:
    """Sample an action from the policy, then estimate
    (ref ``sample_gradient_data``, ``gradients.jl:117-121``)."""
    flat_params, unravel = ravel_pytree(params)
    action = movedef.policy.sample(params, key, state)
    return pgmc_estimate(movedef, flat_params, unravel, state, action)
