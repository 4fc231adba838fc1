"""ChEES-HMC: adaptive-trajectory-length HMC for massively parallel chains.

An extension beyond the reference (which only ships NUTS/HMC):
ChEES (Change in the Estimator of the Expected Square, Hoffman, Radul &
Sountsov, AISTATS 2021) replaces NUTS's per-chain tree building — inherently
control-flow divergent across chains — with a *shared* jittered trajectory
length tuned by cross-chain stochastic gradient ascent. Every chain runs the
same number of leapfrog steps per iteration, so thousands of chains stay in
perfect lockstep with zero tree bookkeeping: the per-iteration cost is the
leapfrog alone. The cross-chain reductions (criterion gradient, harmonic-mean
acceptance) are exactly the kind of collective a sharded chain axis gives for
free on a device mesh.

Scheme per iteration (all chains at once, lane-minor):
  * trajectory time t = h * T with h the base-2 Halton point of the
    iteration counter (shared by all chains -> shared leapfrog count
    n = ceil(t / eps), clipped to ``max_leapfrogs``);
  * full momentum refresh, n leapfrog steps, per-chain MH accept;
  * warmup: T <- Adam ascent on the ChEES criterion gradient
      g = sum_c w_c a_c <q'_c - mean q', v'_c> h / sum_c w_c,
    with a_c = ||q'_c - mean q'||^2 - ||q_c - mean q||^2 and w_c the accept
    probability (proposals, not accepted states, enter the estimate);
  * warmup: dual averaging of the *shared* step size targeting the
    harmonic-mean acceptance across chains (default target 0.651).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .metrics import sample_momentum_b
from .nuts import _metric_t, compute_state_t, leapfrog_t
from .step_size import StepSizeState, update_step_size

__all__ = ['CheesAdaptState', 'CheesStats', 'init_chees_adapt',
           'chees_transition_batched', 'chees_adapt_update', 'halton2']


class CheesAdaptState(NamedTuple):
    step: StepSizeState      # shared scalar dual-averaging state
    log_T: jnp.ndarray       # log trajectory time
    adam_m: jnp.ndarray
    adam_v: jnp.ndarray
    count: jnp.ndarray       # int32 iteration counter (drives the jitter)


class CheesStats(NamedTuple):
    logp: jnp.ndarray
    energy: jnp.ndarray
    n_int_step: jnp.ndarray
    accept_stat: jnp.ndarray
    accepted: jnp.ndarray
    traj_len: jnp.ndarray
    energy_change: jnp.ndarray
    diverging: jnp.ndarray


def init_chees_adapt(initial_step, initial_traj_len, dtype=jnp.float32):
    from .step_size import init_step_size
    return CheesAdaptState(
        step=init_step_size(jnp.asarray(initial_step, dtype), dtype),
        log_T=jnp.log(jnp.asarray(initial_traj_len, dtype)),
        adam_m=jnp.zeros((), dtype), adam_v=jnp.zeros((), dtype),
        count=jnp.zeros((), jnp.int32))


def halton2(i):
    """Base-2 radical inverse (Halton) of the int32 counter ``i + 1`` in
    (0, 1): bit-reverse the counter. Low-discrepancy jitter keeps the
    trajectory-length gradient estimates stable (Hoffman et al. 2021)."""
    x = (i + 1).astype(jnp.uint32)
    x = ((x & jnp.uint32(0x55555555)) << 1) | \
        ((x & jnp.uint32(0xAAAAAAAA)) >> 1)
    x = ((x & jnp.uint32(0x33333333)) << 2) | \
        ((x & jnp.uint32(0xCCCCCCCC)) >> 2)
    x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | \
        ((x & jnp.uint32(0xF0F0F0F0)) >> 4)
    x = ((x & jnp.uint32(0x00FF00FF)) << 8) | \
        ((x & jnp.uint32(0xFF00FF00)) >> 8)
    x = (x << 16) | (x >> 16)
    return x.astype(jnp.float64 if jax.config.jax_enable_x64
                    else jnp.float32) * (2.0 ** -32)


def chees_transition_batched(key, q0, metric, eps, traj_len, h, logp_and_grad,
                             max_leapfrogs, max_change):
    """One ChEES-HMC iteration for all chains.

    ``q0`` (C, D); ``eps``/``traj_len``/``h`` shared scalars. Returns
    ``(q_new, stats, aux)`` where ``aux = (q_prop, v_prop, accept_prob)``
    feeds the trajectory-length adaptation.
    """
    C, D = q0.shape
    dtype = q0.dtype
    key, k_mom, k_acc = jax.random.split(key, 3)
    p0 = sample_momentum_b(metric, k_mom, (C, D), dtype)
    metric_t = _metric_t(metric)

    def lpg_t(x_t):
        logp, grad = logp_and_grad(x_t.T)
        return logp, grad.T

    start = compute_state_t(metric_t, lpg_t, q0.T, p0.T)
    n_step = jnp.clip(jnp.ceil(h * traj_len / eps).astype(jnp.int32),
                      1, int(max_leapfrogs))
    eps_c = jnp.broadcast_to(jnp.asarray(eps, dtype), (C,))

    def body(_, s):
        return leapfrog_t(metric_t, lpg_t, eps_c, s)

    end = jax.lax.fori_loop(0, n_step, body, start)

    d_energy = end.energy - start.energy
    d_energy = jnp.where(jnp.isnan(d_energy), jnp.inf, d_energy)
    diverging = ~(jnp.abs(d_energy) < max_change)
    accept_prob = jnp.where(diverging, 0.0,
                            jnp.minimum(1.0, jnp.exp(-d_energy)))
    accepted = jax.random.uniform(k_acc, (C,)) < accept_prob
    q_new = jnp.where(accepted, end.q, start.q).T

    stats = CheesStats(
        logp=jnp.where(accepted, end.logp, start.logp),
        energy=jnp.where(accepted, end.energy, start.energy),
        n_int_step=jnp.broadcast_to(n_step, (C,)),
        accept_stat=accept_prob, accepted=accepted,
        traj_len=jnp.broadcast_to(jnp.asarray(traj_len, dtype), (C,)),
        energy_change=d_energy, diverging=diverging)
    return q_new, stats, (end.q.T, end.v.T, accept_prob)


def chees_adapt_update(adapt, q_old, q_prop, v_prop, accept_prob, h, eps,
                       warmup, target=0.651, gamma=0.05, k=0.75, t_0=10.,
                       adapt_step_size=True, adapt_traj_len=True,
                       lr=0.025, max_leapfrogs=1024):
    """Shared-state adaptation step (masked outside warmup).

    Adam ascent on the ChEES criterion gradient for ``log_T``; dual
    averaging of the shared step size on the harmonic-mean acceptance.
    """
    dtype = q_old.dtype

    # ---- ChEES gradient for the trajectory length ----
    m_old = jnp.mean(q_old, axis=0)
    m_prop = jnp.mean(q_prop, axis=0)
    a = (jnp.sum((q_prop - m_prop) ** 2, axis=-1) -
         jnp.sum((q_old - m_old) ** 2, axis=-1))
    b = jnp.sum((q_prop - m_prop) * v_prop, axis=-1)
    w = accept_prob
    w_sum = jnp.maximum(jnp.sum(w), 1e-10)
    grad = jnp.sum(w * a * b, axis=0) * h / w_sum

    do_T = jnp.asarray(warmup) & jnp.asarray(adapt_traj_len)
    t_adam = adapt.count.astype(dtype) + 1.0
    b1, b2 = 0.9, 0.999
    m_new = b1 * adapt.adam_m + (1 - b1) * grad
    v_new = b2 * adapt.adam_v + (1 - b2) * grad ** 2
    m_hat = m_new / (1 - b1 ** t_adam)
    v_hat = v_new / (1 - b2 ** t_adam)
    step_T = lr * m_hat / (jnp.sqrt(v_hat) + 1e-8)
    # keep T within sane bounds: at least one leapfrog, at most the budget
    log_T_new = jnp.clip(adapt.log_T + step_T,
                         jnp.log(eps),
                         jnp.log(eps * max_leapfrogs))
    # a non-finite gradient (all proposals rejected etc.) must not poison T
    log_T_new = jnp.where(jnp.isfinite(log_T_new), log_T_new, adapt.log_T)

    # ---- shared step size: dual averaging on harmonic-mean acceptance ----
    hm_accept = 1.0 / jnp.mean(1.0 / jnp.maximum(accept_prob, 1e-4))
    step_new = update_step_size(adapt.step, hm_accept, warmup, target, gamma,
                                k, t_0, adapt_step_size)

    return CheesAdaptState(
        step=step_new,
        log_T=jnp.where(do_T, log_T_new, adapt.log_T),
        adam_m=jnp.where(do_T, m_new, adapt.adam_m),
        adam_v=jnp.where(do_T, v_new, adapt.adam_v),
        count=adapt.count + 1)
