"""Leapfrog integrator as a pure function.

Counterpart of ``bayesfast/samplers/hmc_utils/integration.py:21-95``: the
BLAS-``axpy`` half-kick / drift / half-kick update becomes a fused XLA
expression; one ``logp_and_grad`` evaluation per step (the innermost hot
call, batched across chains by ``vmap`` so the density evaluates as large
batches).
"""

from typing import NamedTuple

import jax.numpy as jnp

from .metrics import velocity, kinetic_energy

__all__ = ['IntegratorState', 'leapfrog', 'compute_state']


class IntegratorState(NamedTuple):
    q: jnp.ndarray       # position (dim,)
    p: jnp.ndarray       # momentum (dim,)
    v: jnp.ndarray       # velocity M^{-1} p (dim,)
    grad: jnp.ndarray    # d logp / dq (dim,)
    energy: jnp.ndarray  # scalar H = K - logp
    logp: jnp.ndarray    # scalar


def compute_state(metric, logp_and_grad, q, p):
    """Hamiltonian state at (q, p) (``integration.py:28-34``)."""
    logp, grad = logp_and_grad(q)
    v = velocity(metric, p)
    energy = kinetic_energy(p, v) - logp
    return IntegratorState(q, p, v, grad, energy, logp)


def leapfrog(metric, logp_and_grad, eps, s):
    """One leapfrog step (``integration.py:68-95``)."""
    dt = 0.5 * eps
    p_half = s.p + dt * s.grad
    v_half = velocity(metric, p_half)
    q_new = s.q + eps * v_half
    logp, grad = logp_and_grad(q_new)
    p_new = p_half + dt * grad
    v_new = velocity(metric, p_new)
    energy = kinetic_energy(p_new, v_new) - logp
    return IntegratorState(q_new, p_new, v_new, grad, energy, logp)

