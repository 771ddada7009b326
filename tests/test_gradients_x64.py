"""Float64 gradient cross-validation at reference strength.

The reference asserts three independent AD backends agree to 1e-10
(``test/ad_backends_test.jl:31-32``).  This build has one AD backend
(``jax.grad``); the equivalent strength of evidence is a three-way x64
cross-check — AD vs the hand-derived analytic gradient vs central finite
differences — at the same 1e-10 tolerance, for BOTH policies:

- ``StandardGaussian`` (the reference's policy), and
- ``LangevinGaussian`` (MALA), where the parameter gradient flows through
  the *drift term* — the highest-risk gradient in the codebase, which the
  float32 tier never cross-checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from montecarlo_tpu.models import particle1d as p1d

TOL = 1e-10


def _ad_grad(policy, params, action, state):
    flat, unravel = ravel_pytree(params)
    logq, grad = jax.value_and_grad(
        lambda fp: policy.log_density(unravel(fp), action, state))(flat)
    return float(logq), float(grad[0])


def _fd_grad(policy, params, action, state, key, h=1e-6):
    up = {**params, key: params[key] + h}
    dn = {**params, key: params[key] - h}
    return float(policy.log_density(up, action, state)
                 - policy.log_density(dn, action, state)) / (2.0 * h)


@pytest.mark.parametrize("sigma,delta", [(0.2, -1.3), (0.7, 0.05),
                                         (1.5, 2.0)])
def test_standard_gaussian_three_way_x64(sigma, delta):
    with jax.enable_x64():
        policy = p1d.StandardGaussian()
        params = {"sigma": jnp.asarray(sigma, jnp.float64)}
        a = jnp.asarray(delta, jnp.float64)
        logq, g_ad = _ad_grad(policy, params, a, None)

        # analytic: logq = -a^2/(2 s^2) - log(sqrt(2 pi) s)
        logq_an = (-delta ** 2 / (2 * sigma ** 2)
                   - 0.5 * np.log(2 * np.pi * sigma ** 2))
        g_an = delta ** 2 / sigma ** 3 - 1.0 / sigma
        g_fd = _fd_grad(policy, params, a, None, "sigma")

        assert abs(logq - logq_an) <= TOL * max(1.0, abs(logq_an))
        assert abs(g_ad - g_an) <= TOL * max(1.0, abs(g_an))
        assert abs(g_fd - g_an) <= 1e-8 * max(1.0, abs(g_an))  # fd: O(h^2)
        assert abs(g_ad - g_fd) <= 1e-8 * max(1.0, abs(g_ad))


@pytest.mark.parametrize("eps,beta,x,delta", [(0.3, 2.0, 0.7, 0.5),
                                              (0.05, 2.5, -1.2, -0.3),
                                              (1.1, 1.0, 0.0, 0.9)])
def test_langevin_gaussian_three_way_x64(eps, beta, x, delta):
    """Gradient THROUGH the MALA drift: with U = x^2 (U' = 2x),

        drift(eps)  = -eps * beta * 2x
        d           = a - drift = a + 2 eps beta x
        dd/d eps    = 2 beta x
        logq        = -d^2/(4 eps) - 1/2 log(4 pi eps)
        dlogq/d eps = -(d * dd/deps)/(2 eps) + d^2/(4 eps^2) - 1/(2 eps)
    """
    with jax.enable_x64():
        policy = p1d.LangevinGaussian(p1d.harmonic)
        params = {"step": jnp.asarray(eps, jnp.float64)}
        state = p1d.Particle1DState(
            x=jnp.asarray(x, jnp.float64),
            beta=jnp.asarray(beta, jnp.float64),
            e=jnp.asarray(x * x, jnp.float64))
        a = jnp.asarray(delta, jnp.float64)
        logq, g_ad = _ad_grad(policy, params, a, state)

        d = delta + 2.0 * eps * beta * x
        dd = 2.0 * beta * x
        logq_an = -d * d / (4 * eps) - 0.5 * np.log(4 * np.pi * eps)
        g_an = -(d * dd) / (2 * eps) + d * d / (4 * eps ** 2) - 1 / (2 * eps)
        g_fd = _fd_grad(policy, params, a, state, "step")

        assert abs(logq - logq_an) <= TOL * max(1.0, abs(logq_an))
        assert abs(g_ad - g_an) <= TOL * max(1.0, abs(g_an))
        assert abs(g_fd - g_an) <= 1e-6 * max(1.0, abs(g_an))  # fd: O(h^2)
        assert abs(g_ad - g_fd) <= 1e-6 * max(1.0, abs(g_ad))


def test_langevin_proposal_is_asymmetric_x64():
    """The MALA forward and backward log-densities must differ (the generic
    kernel's invert-then-backward recipe is what makes MALA correct); a
    symmetric-cancellation bug here would silently bias sampling."""
    with jax.enable_x64():
        policy = p1d.LangevinGaussian(p1d.harmonic)
        params = {"step": jnp.asarray(0.3, jnp.float64)}
        st0 = p1d.Particle1DState(x=jnp.asarray(0.7, jnp.float64),
                                  beta=jnp.asarray(2.0, jnp.float64),
                                  e=jnp.asarray(0.49, jnp.float64))
        a = jnp.asarray(0.5, jnp.float64)
        st1 = p1d.Particle1DState(x=st0.x + a, beta=st0.beta,
                                  e=(st0.x + a) ** 2)
        logq_f = float(policy.log_density(params, a, st0))
        logq_b = float(policy.log_density(params, -a, st1))
        assert abs(logq_f - logq_b) > 1e-3


def test_pgmc_estimate_x64_internal_consistency():
    """pgmc_estimate in x64 for the MALA move: j, grad_j and g must satisfy
    their defining identities against independently recomputed pieces
    (ref ``pgmc_estimate``, ``gradients.jl:93-109``)."""
    with jax.enable_x64():
        from montecarlo_tpu import policy_guided as pg
        move = p1d.mala_move(step=0.3)
        beta, x0, delta = 2.0, 0.9, -0.4
        state = p1d.Particle1DState(x=jnp.asarray(x0, jnp.float64),
                                    beta=jnp.asarray(beta, jnp.float64),
                                    e=jnp.asarray(x0 ** 2, jnp.float64))
        params = {"step": jnp.asarray(0.3, jnp.float64)}
        flat, unravel = ravel_pytree(params)
        a = jnp.asarray(delta, jnp.float64)
        gd = pg.pgmc_estimate(move.move, flat, unravel, state, a)

        policy = move.move.policy
        xn = x0 + delta
        st1 = p1d.Particle1DState(x=jnp.asarray(xn, jnp.float64),
                                  beta=jnp.asarray(beta, jnp.float64),
                                  e=jnp.asarray(xn ** 2, jnp.float64))
        logq_f, g_f = _ad_grad(policy, params, a, state)
        logq_b, g_b = _ad_grad(policy, params, -a, st1)
        dlogp = -beta * (xn ** 2 - x0 ** 2)
        log_ratio = dlogp + logq_b - logq_f
        alpha = min(1.0, np.exp(log_ratio))
        j = delta ** 2 * alpha
        g_used = g_f if log_ratio >= 0 else g_b
        assert abs(float(gd.j) - j) <= TOL * max(1.0, abs(j))
        assert abs(float(gd.grad_j[0]) - j * g_used) <= 1e-9
        assert abs(float(gd.grad_logq_forward[0]) - g_f) <= 1e-9
        assert abs(float(gd.g[0, 0]) - g_f ** 2) <= 1e-9
