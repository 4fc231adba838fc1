"""Affine-invariant ensemble sampler (emcee-style stretch moves).

The reference plans but never implements this (``samplers/ensemble.py:13-15``
raises NotImplementedError). The stretch-move ensemble is a natural fit for
a batched accelerator program: the walker population is one batched array, each
half-update is a fused gather + elementwise accept over hundreds of walkers,
and no gradients are needed (so it also suits densities whose gradients are
unavailable).

Algorithm (Goodman & Weare 2010; emcee's parallel variant): split walkers
into two halves; for each walker x_k in the active half draw a complementary
walker x_j and a stretch z ~ g(z) prop. 1/sqrt(z) on [1/a, a], propose
y = x_j + z (x_k - x_j), accept with probability
min(1, z^(d-1) exp(logp(y) - logp(x_k))).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ['EnsembleStats', 'ensemble_step', 'run_ensemble']


class EnsembleStats(NamedTuple):
    logp: jnp.ndarray       # (n_walker,)
    accept_stat: jnp.ndarray
    accepted: jnp.ndarray
    warmup: jnp.ndarray


def _half_update(key, active, other, logp_active, logp_fn, a):
    """Stretch-move update of one half against the complementary half."""
    n_act, dim = active.shape
    k_z, k_j, k_u = jax.random.split(key, 3)
    # z ~ g(z) prop. 1/sqrt(z) on [1/a, a]: z = ((a-1) u + 1)^2 / a
    u = jax.random.uniform(k_z, (n_act,), active.dtype)
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    j = jax.random.randint(k_j, (n_act,), 0, other.shape[0])
    xj = other[j]
    prop = xj + z[:, None] * (active - xj)
    logp_prop = jax.vmap(logp_fn)(prop)
    log_accept = (dim - 1) * jnp.log(z) + logp_prop - logp_active
    log_accept = jnp.where(jnp.isnan(log_accept), -jnp.inf, log_accept)
    accept = jnp.log(jax.random.uniform(k_u, (n_act,), active.dtype)) \
        < log_accept
    new = jnp.where(accept[:, None], prop, active)
    new_logp = jnp.where(accept, logp_prop, logp_active)
    p_acc = jnp.minimum(1.0, jnp.exp(log_accept))
    return new, new_logp, accept, p_acc


def ensemble_step(key, x, logp_x, logp_fn, a=2.0):
    """One full ensemble iteration (both halves); x is (n_walker, dim)."""
    n = x.shape[0]
    half = n // 2
    k1, k2 = jax.random.split(key)

    x0, x1 = x[:half], x[half:]
    lp0, lp1 = logp_x[:half], logp_x[half:]
    x0, lp0, acc0, p0 = _half_update(k1, x0, x1, lp0, logp_fn, a)
    x1, lp1, acc1, p1 = _half_update(k2, x1, x0, lp1, logp_fn, a)

    x_new = jnp.concatenate([x0, x1])
    lp_new = jnp.concatenate([lp0, lp1])
    accepted = jnp.concatenate([acc0, acc1])
    p_acc = jnp.concatenate([p0, p1])
    return x_new, lp_new, accepted, p_acc


def run_ensemble(key, x_0, logp_fn, n_steps, warmup_flags, a=2.0):
    """Scan ``n_steps`` ensemble iterations; returns (x, lp, samples, stats).

    ``samples`` is (n_steps, n_walker, dim); stats leaves (n_steps,
    n_walker).
    """
    lp0 = jax.vmap(logp_fn)(x_0)

    def step(carry, w):
        key, x, lp = carry
        key, sub = jax.random.split(key)
        x, lp, accepted, p_acc = ensemble_step(sub, x, lp, logp_fn, a)
        stats = EnsembleStats(logp=lp, accept_stat=p_acc, accepted=accepted,
                              warmup=jnp.broadcast_to(w, p_acc.shape))
        return (key, x, lp), (x, stats)

    (key, x, lp), (samples, stats) = jax.lax.scan(
        step, (key, x_0, lp0), warmup_flags)
    return x, lp, samples, stats
