"""Policy-gradient optimisers.

One pure update rule per optimiser, mirroring the formulas of
``src/PolicyGuided/learning.jl`` exactly (on flat parameter vectors):

- ``Static``  — no-op                              (``learning.jl:16``)
- ``VPG``     — θ += η ∇j                          (``learning.jl:23-34``)
- ``BLPG``    — θ += η (∇j − j ∇logq_f)            (``learning.jl:41-52``)
- ``BLAPG``   — adaptive step η=√(2δ/(‖∇j‖²+ε))    (``learning.jl:59-79``)
- ``NPG``     — θ += η (g+εI)⁻¹ ∇j                 (``learning.jl:86-105``)
- ``ANPG``    — adaptive natural                    (``learning.jl:113-134``)
- ``BLANPG``  — baseline + adaptive + natural       (``learning.jl:142-164``)

Parameter dimensions are tiny, so the (P, P) inverses are negligible.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .gradients import GradientData

__all__ = ["PolicyGradient", "Static", "VPG", "BLPG", "BLAPG", "NPG", "ANPG",
           "BLANPG", "learning_step"]


class PolicyGradient:
    """Abstract optimiser (ref ``PolicyGradient``, ``learning.jl:9``)."""

    def update(self, flat_params, gd: GradientData):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Static(PolicyGradient):
    def update(self, flat_params, gd):
        return flat_params


@dataclasses.dataclass(frozen=True)
class VPG(PolicyGradient):
    eta: float

    def update(self, p, gd):
        return p + self.eta * gd.grad_j


@dataclasses.dataclass(frozen=True)
class BLPG(PolicyGradient):
    eta: float

    def update(self, p, gd):
        return p + self.eta * (gd.grad_j - gd.j * gd.grad_logq_forward)


@dataclasses.dataclass(frozen=True)
class BLAPG(PolicyGradient):
    delta: float
    eps_id: float = 0.0

    def update(self, p, gd):
        eta = jnp.sqrt(2.0 * self.delta
                       / (_dot(gd.grad_j, gd.grad_j) + self.eps_id))
        return p + eta * (gd.grad_j - gd.j * gd.grad_logq_forward)


def _dot(a, b):
    """Full float32 product: a GPU may otherwise run a float32 ``@`` in TF32
    (about three decimal digits)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _inv_reg(g, eps_id):
    if g.shape[0] == 1:  # scalar fast path: avoid the general LU pipeline
        return 1.0 / (g + eps_id)
    return jnp.linalg.inv(g + eps_id * jnp.eye(g.shape[0], dtype=g.dtype))


@dataclasses.dataclass(frozen=True)
class NPG(PolicyGradient):
    eta: float
    eps_id: float = 0.0

    def update(self, p, gd):
        return p + self.eta * _dot(_inv_reg(gd.g, self.eps_id), gd.grad_j)


@dataclasses.dataclass(frozen=True)
class ANPG(PolicyGradient):
    delta: float
    eps_id: float = 0.0

    def update(self, p, gd):
        f_inv = _inv_reg(gd.g, self.eps_id)
        eta = jnp.sqrt(2.0 * self.delta
                       / _dot(gd.grad_j, _dot(f_inv, gd.grad_j)))
        return p + eta * _dot(f_inv, gd.grad_j)


@dataclasses.dataclass(frozen=True)
class BLANPG(PolicyGradient):
    delta: float
    eps_id: float = 0.0

    def update(self, p, gd):
        f_inv = _inv_reg(gd.g, self.eps_id)
        d = gd.grad_j - gd.j * gd.grad_logq_forward
        eta = jnp.sqrt(2.0 * self.delta / _dot(d, _dot(f_inv, d)))
        return p + eta * _dot(f_inv, d)


def learning_step(optimiser: PolicyGradient, flat_params, gd: GradientData):
    """Apply one optimiser update (ref ``learning_step!`` methods)."""
    return optimiser.update(flat_params, gd)
