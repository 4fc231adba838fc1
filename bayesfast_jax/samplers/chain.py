"""Batched multi-chain driver: vmap over chains, scan over iterations.

This replaces the reference's process-per-chain architecture
(``bayesfast/core/sample.py:165-214`` + ``base_hmc.py:87-172``): instead of a
worker pool picking one chain each, all chains advance in lockstep inside a
single jitted program, with the chain axis ready to be sharded over a device
mesh. Per-chain adaptation state (dual-averaging step size, Welford metric)
lives in the scan carry; samples and per-iteration statistics come out as
stacked arrays.
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from .chees import chees_transition_batched, chees_adapt_update, halton2
from .hmc import hmc_transition
from .metrics import update_metric, update_metric_pooled
from .nuts import nuts_transition_batched
from .step_size import current_step_size, update_step_size
from .tempered import tnuts_transition_batched, thmc_transition

__all__ = ['ChainCarry', 'ChainDriver']


class ChainCarry(NamedTuple):
    key: Any      # (n_chain,) PRNG keys
    q: Any        # (n_chain, dim)
    step: Any     # StepSizeState, batched over chains
    metric: Any   # Diag/FullMetricState, batched over chains


class ChainDriver:
    """Compiles and runs the batched sampling loop for one configuration.

    Parameters mirror the reference trace configs (``sample_trace.py:157-537``).
    ``algorithm`` is 'nuts' or 'hmc'.
    """

    def __init__(self, logp_and_grad, algorithm='nuts', max_treedepth=10,
                 n_int_step=32, max_change=1000., target_accept=0.8,
                 gamma=0.05, k=0.75, t_0=10., adapt_step_size=True,
                 update_window=1, doubling=True, adapt_metric=True,
                 logp_and_grad_base=None, pooled_metric=False,
                 max_leapfrogs=1024, adapt_traj_len=True, chees_lr=0.025):
        self._max_leapfrogs = int(max_leapfrogs)
        self._adapt_traj_len = bool(adapt_traj_len)
        self._chees_lr = float(chees_lr)
        self._logp_and_grad = logp_and_grad
        self._logp_and_grad_base = logp_and_grad_base
        self._algorithm = algorithm
        self._max_treedepth = int(max_treedepth)
        self._n_int_step = int(n_int_step)
        self._max_change = float(max_change)
        self._target_accept = float(target_accept)
        self._gamma = float(gamma)
        self._k = float(k)
        self._t_0 = float(t_0)
        self._adapt_step_size = bool(adapt_step_size)
        self._update_window = int(update_window)
        self._doubling = bool(doubling)
        self._adapt_metric = bool(adapt_metric)
        self._pooled_metric = bool(pooled_metric)
        self._compiled = None

    def _one_chain_step(self, key, q, step_state, metric, warmup, params):
        """Per-chain transition for the fixed-trajectory algorithms
        (hmc/thmc); vmapped over chains by ``_build``."""
        tempered = self._algorithm == 'thmc'
        if tempered:
            # q holds [u, q...] (the extended tempering coordinate first)
            params_t, params_b = params
            lpg = lambda x: self._logp_and_grad(params_t, x)
            lpg_b = lambda x: self._logp_and_grad_base(params_b, x)
            u, qq = q[0], q[1:]
        else:
            lpg = lambda x: self._logp_and_grad(params, x)
        eps = current_step_size(step_state, warmup)
        key, k_t = jax.random.split(key)
        if self._algorithm == 'hmc':
            q_new, stats = hmc_transition(
                k_t, q, metric, eps, lpg,
                self._n_int_step, self._max_change)
            accept_stat = stats.accept_stat
        elif self._algorithm == 'thmc':
            q_new, u_new, stats = thmc_transition(
                k_t, qq, u, metric, eps, lpg, lpg_b,
                self._n_int_step, self._max_change)
            accept_stat = stats.accept_stat
            q_new = jnp.concatenate([u_new[None], q_new])
        else:
            raise ValueError(f'unknown algorithm {self._algorithm}.')
        step_state = update_step_size(
            step_state, accept_stat, warmup, self._target_accept, self._gamma,
            self._k, self._t_0, self._adapt_step_size)
        # step sizes recorded *after* the update, as in ``base_hmc.py:80-84``;
        # the metric update happens at the batch level in scan_fn (shared or
        # per chain depending on pooled_metric)
        extras = {'step_size': jnp.exp(step_state.log_step),
                  'step_size_bar': jnp.exp(step_state.log_bar),
                  'warmup': warmup}
        return key, q_new, step_state, (stats, extras)

    def _batched_step(self, keys, q, step_state, metric, warmup, params):
        """Batch-first transition for the tree algorithms (nuts/tnuts): the
        whole chain batch advances in one flat tree-building loop (see
        ``nuts.nuts_core_batched``), with adaptation updates running as
        elementwise batched ops — nothing here is vmapped."""
        tempered = self._algorithm == 'tnuts'
        # advance the per-chain key streams; the kernel's per-lane
        # randomness comes from counter-based (C,)-shaped draws of one key
        splits = jax.vmap(lambda kk: jax.random.split(kk, 2))(keys)
        new_keys, k_core = splits[:, 0], splits[:, 1][0]
        eps = current_step_size(step_state, warmup)
        if tempered:
            params_t, params_b = params
            lpg_b = jax.vmap(lambda x: self._logp_and_grad(params_t, x))
            lpg_base_b = jax.vmap(
                lambda x: self._logp_and_grad_base(params_b, x))
            u, qq = q[:, 0], q[:, 1:]
            q_new, u_new, stats = tnuts_transition_batched(
                k_core, qq, u, metric, eps, lpg_b, lpg_base_b,
                self._max_treedepth, self._max_change)
            q_new = jnp.concatenate([u_new[:, None], q_new], axis=1)
        else:
            lpg_b = jax.vmap(lambda x: self._logp_and_grad(params, x))
            q_new, stats = nuts_transition_batched(
                k_core, q, metric, eps, lpg_b,
                self._max_treedepth, self._max_change)
        accept_stat = stats.mean_tree_accept
        step_state = update_step_size(
            step_state, accept_stat, warmup, self._target_accept, self._gamma,
            self._k, self._t_0, self._adapt_step_size)
        extras = {'step_size': jnp.exp(step_state.log_step),
                  'step_size_bar': jnp.exp(step_state.log_bar),
                  'warmup': jnp.broadcast_to(warmup, accept_stat.shape)}
        return new_keys, q_new, step_state, (stats, extras)

    def _chees_step(self, keys, q, adapt, metric, warmup, params):
        """Batch-first ChEES-HMC step: shared jittered trajectory, per-chain
        MH, cross-chain trajectory-length/step-size adaptation."""
        splits = jax.vmap(lambda kk: jax.random.split(kk, 2))(keys)
        new_keys, k_core = splits[:, 0], splits[:, 1][0]
        lpg_b = jax.vmap(lambda x: self._logp_and_grad(params, x))
        eps = current_step_size(adapt.step, warmup)
        h = halton2(adapt.count)
        traj_len = jnp.exp(adapt.log_T)
        q_new, stats, (q_prop, v_prop, ap) = chees_transition_batched(
            k_core, q, metric, eps, traj_len, h, lpg_b,
            self._max_leapfrogs, self._max_change)
        adapt = chees_adapt_update(
            adapt, q, q_prop, v_prop, ap, h, eps, warmup,
            self._target_accept, self._gamma, self._k, self._t_0,
            self._adapt_step_size, self._adapt_traj_len, self._chees_lr,
            self._max_leapfrogs)
        shape = stats.accept_stat.shape
        extras = {
            'step_size': jnp.broadcast_to(jnp.exp(adapt.step.log_step),
                                          shape),
            'step_size_bar': jnp.broadcast_to(jnp.exp(adapt.step.log_bar),
                                              shape),
            'warmup': jnp.broadcast_to(warmup, shape)}
        return new_keys, q_new, adapt, (stats, extras)

    def _build(self):
        if self._algorithm == 'chees':
            batched = self._chees_step
        elif self._algorithm in ('nuts', 'tnuts'):
            batched = self._batched_step
        else:
            metric_axis = None if self._pooled_metric else 0
            batched = jax.vmap(self._one_chain_step,
                               in_axes=(0, 0, 0, metric_axis, None, None))
        tempered = self._algorithm in ('tnuts', 'thmc')

        def scan_fn(carry, warmup_flags, params):
            def step(c, w):
                key, q, ss, out = batched(c.key, c.q, c.step, c.metric, w,
                                          params)
                qm = q[:, 1:] if tempered else q
                if not self._adapt_metric:
                    ms = c.metric
                elif self._pooled_metric:
                    # shared mass matrix fed by all chains (cross-chain
                    # pooled adaptation, an extension beyond the reference)
                    ms = update_metric_pooled(c.metric, qm, w,
                                              self._update_window,
                                              self._doubling)
                else:
                    ms = jax.vmap(update_metric,
                                  in_axes=(0, 0, None, None, None))(
                        c.metric, qm, w, self._update_window, self._doubling)
                return ChainCarry(key, q, ss, ms), (q, out)
            return jax.lax.scan(step, carry, warmup_flags)

        return jax.jit(scan_fn, donate_argnums=(0,))

    def run(self, carry, warmup_flags, params=()):
        """Run ``len(warmup_flags)`` iterations; returns (carry, (samples, stats)).

        ``samples`` has shape (n_steps, n_chain, dim); stats leaves are
        (n_steps, n_chain). ``params`` is the density's dynamic-parameter
        pytree (surrogate coefficients etc.), threaded as a runtime argument
        so refits do not recompile.
        """
        if self._compiled is None:
            self._compiled = self._build()
        return self._compiled(carry, jnp.asarray(warmup_flags), params)
