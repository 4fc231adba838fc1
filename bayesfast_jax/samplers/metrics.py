"""Mass-matrix (quadratic metric) states and Welford adaptation, functional.

Functional counterpart of ``bayesfast/samplers/hmc_utils/metrics.py``. The
reference's mutable ``QuadMetric*`` objects become immutable pytree states
carried through the sampling ``lax.scan``; the Welford foreground/background
window switching with window doubling (``metrics.py:186-211, 300-326``) is
reproduced with ``jnp.where`` masking so thousands of chains adapt in
lockstep.

Two metric families (selected statically, giving two jit variants):
  * diag  — ``var`` (dim,):      velocity = var * p,  p ~ N(0, diag(1/var))
  * full  — ``cov`` (dim, dim):  velocity = cov @ p,  p ~ N(0, cov^{-1})

Semantics notes kept from the reference:
  * ``current_variance`` divides by the total weight (including the initial
    pseudo-weight 10), not n-1 (``metrics.py:362-368``).
  * With ``update_window=1`` the metric refreshes every warmup iteration.
  * On a failed Cholesky of the adapted full covariance the previous factor
    is kept while the covariance still updates (``metrics.py:293-298``).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ['DiagMetricState', 'FullMetricState', 'init_diag_metric',
           'init_full_metric', 'velocity', 'kinetic_energy',
           'sample_momentum', 'update_metric', 'sample_momentum_b']


class _Welford(NamedTuple):
    mean: jnp.ndarray   # (dim,)
    raw: jnp.ndarray    # (dim,) for diag, (dim, dim) for full
    weight: jnp.ndarray  # scalar


class DiagMetricState(NamedTuple):
    var: jnp.ndarray          # (dim,) current metric diagonal covariance
    fg: _Welford
    bg: _Welford
    n_samples: jnp.ndarray    # int32 scalar
    prev_update: jnp.ndarray  # int32 scalar
    adapt_window: jnp.ndarray  # int32 scalar (doubles over warmup)


class FullMetricState(NamedTuple):
    cov: jnp.ndarray          # (dim, dim)
    chol: jnp.ndarray         # (dim, dim) lower Cholesky of cov
    fg: _Welford
    bg: _Welford
    n_samples: jnp.ndarray
    prev_update: jnp.ndarray
    adapt_window: jnp.ndarray


def _zero_welford(dim, dtype, full):
    shape = (dim, dim) if full else (dim,)
    return _Welford(jnp.zeros((dim,), dtype), jnp.zeros(shape, dtype),
                    jnp.zeros((), dtype))


def init_diag_metric(initial_mean, initial_var, initial_weight=10.,
                     adapt_window=60):
    """Build the initial diag metric state (``metrics.py:148-179``)."""
    mean = jnp.asarray(initial_mean)
    var = jnp.asarray(initial_var)
    dtype = var.dtype
    w = jnp.asarray(initial_weight, dtype)
    fg = _Welford(mean, var * w, w)
    return DiagMetricState(
        var=var, fg=fg, bg=_zero_welford(var.shape[0], dtype, False),
        n_samples=jnp.zeros((), jnp.int32),
        prev_update=jnp.zeros((), jnp.int32),
        adapt_window=jnp.asarray(adapt_window, jnp.int32))


def init_full_metric(initial_mean, initial_cov, initial_weight=10.,
                     adapt_window=60):
    """Build the initial full metric state (``metrics.py:259-291``)."""
    mean = jnp.asarray(initial_mean)
    cov = jnp.asarray(initial_cov)
    dtype = cov.dtype
    w = jnp.asarray(initial_weight, dtype)
    fg = _Welford(mean, cov * w, w)
    return FullMetricState(
        cov=cov, chol=jnp.linalg.cholesky(cov), fg=fg,
        bg=_zero_welford(cov.shape[0], dtype, True),
        n_samples=jnp.zeros((), jnp.int32),
        prev_update=jnp.zeros((), jnp.int32),
        adapt_window=jnp.asarray(adapt_window, jnp.int32))


def velocity(metric, p):
    """M^{-1} p (the reference's ``QuadMetric.velocity``)."""
    if isinstance(metric, DiagMetricState):
        return metric.var * p
    return metric.cov @ p


def kinetic_energy(p, v):
    return 0.5 * jnp.dot(p, v)


def sample_momentum(metric, key):
    """Draw p ~ N(0, M) where M = cov^{-1} of the metric's covariance."""
    if isinstance(metric, DiagMetricState):
        z = jax.random.normal(key, metric.var.shape, metric.var.dtype)
        return z / jnp.sqrt(metric.var)
    dim = metric.cov.shape[0]
    z = jax.random.normal(key, (dim,), metric.cov.dtype)
    return jax.scipy.linalg.solve_triangular(metric.chol.T, z, lower=False)


def sample_momentum_b(metric, key, shape, dtype):
    """Draw (C, D) momenta ``p ~ N(0, M)`` with ``M = cov^{-1}`` from a
    single key; the metric may be per-chain or shared across chains."""
    z = jax.random.normal(key, shape, dtype)
    if isinstance(metric, DiagMetricState):
        return z / jnp.sqrt(metric.var)
    chol_t = jnp.swapaxes(metric.chol, -1, -2)
    if chol_t.ndim == 2:
        return jax.scipy.linalg.solve_triangular(chol_t, z.T, lower=False).T
    return jax.scipy.linalg.solve_triangular(
        chol_t, z[..., None], lower=False)[..., 0]


def _welford_add(w, x, full):
    n = w.weight + 1.0
    old_diff = x - w.mean
    mean = w.mean + old_diff / n
    new_diff = x - mean
    if full:
        raw = w.raw + jnp.outer(new_diff, old_diff)
    else:
        raw = w.raw + old_diff * new_diff
    return _Welford(mean, raw, n)


def update_metric(metric, sample, warmup, update_window=1, doubling=True):
    """One adaptation step; no-op (via masking) when ``warmup`` is False."""
    full = isinstance(metric, FullMetricState)
    dim = sample.shape[0]
    dtype = sample.dtype

    delta = metric.n_samples - metric.prev_update
    fg = _welford_add(metric.fg, sample, full)
    bg = _welford_add(metric.bg, sample, full)

    do_refresh = ((delta + 1) % update_window) == 0
    # Stan-style shrinkage at every refresh: blend the sample estimate
    # toward 1e-3 x identity with pseudo-count 5. A bare sample estimate
    # collapses to ~0 for chains that barely moved during the window
    # (far-tail cold starts), which zeroes their velocities and freezes
    # them forever; the regularizer keeps every chain recoverable while
    # still letting genuine geometry shrink the metric by ~weight/5 per
    # window.
    if full:
        eye = jnp.eye(dim, dtype=dtype)
        cov_new = (fg.raw + 5e-3 * eye) / (fg.weight + 5.0)
        chol_new = jnp.linalg.cholesky(cov_new)
        chol_ok = jnp.all(jnp.isfinite(chol_new))
        cov = jnp.where(do_refresh, cov_new, metric.cov)
        chol = jnp.where(do_refresh & chol_ok, chol_new, metric.chol)
    else:
        var = jnp.where(do_refresh, (fg.raw + 5e-3) / (fg.weight + 5.0),
                        metric.var)

    do_switch = delta >= metric.adapt_window
    zero = _zero_welford(dim, dtype, full)
    fg2 = jax.tree.map(lambda a, b: jnp.where(do_switch, b, a), fg, bg)
    bg2 = jax.tree.map(lambda a, b: jnp.where(do_switch, b, a), bg, zero)
    prev_update = jnp.where(do_switch, metric.n_samples, metric.prev_update)
    grown = metric.adapt_window * 2 if doubling else metric.adapt_window
    adapt_window = jnp.where(do_switch, grown, metric.adapt_window)
    n_samples = metric.n_samples + 1

    if full:
        new = FullMetricState(cov, chol, fg2, bg2, n_samples, prev_update,
                              adapt_window)
    else:
        new = DiagMetricState(var, fg2, bg2, n_samples, prev_update,
                              adapt_window)
    # mask the whole update out when not in warmup
    return jax.tree.map(lambda n, o: jnp.where(warmup, n, o), new, metric)


def _welford_add_batch(w, xb, full):
    """Exact parallel Welford merge of a whole batch of samples (Chan et
    al.) — the cross-chain pooled-adaptation primitive. Merging a batch is
    algebraically identical to adding its samples one by one."""
    cb = jnp.asarray(xb.shape[0], xb.dtype)
    mean_b = jnp.mean(xb, axis=0)
    xc = xb - mean_b
    raw_b = xc.T @ xc if full else jnp.sum(xc * xc, axis=0)
    n_new = w.weight + cb
    delta = mean_b - w.mean
    mean_new = w.mean + delta * cb / n_new
    corr = w.weight * cb / n_new
    if full:
        raw_new = w.raw + raw_b + corr * jnp.outer(delta, delta)
    else:
        raw_new = w.raw + raw_b + corr * delta * delta
    return _Welford(mean_new, raw_new, n_new)


def update_metric_pooled(metric, samples, warmup, update_window=1,
                         doubling=True):
    """One pooled adaptation step from ALL chains' new positions.

    An extension of the reference's per-chain Welford adaptation:
    with C chains the shared mass matrix sees C samples per iteration, so
    the metric converges ~C times faster in wall-clock iterations. Window
    bookkeeping stays iteration-counted so the reference's
    foreground/background switching schedule (``metrics.py:186-211``) is
    preserved.
    """
    full = isinstance(metric, FullMetricState)
    dim = samples.shape[-1]
    dtype = samples.dtype

    delta = metric.n_samples - metric.prev_update
    fg = _welford_add_batch(metric.fg, samples, full)
    bg = _welford_add_batch(metric.bg, samples, full)

    do_refresh = ((delta + 1) % update_window) == 0
    # same Stan-style shrinkage as the per-chain update
    if full:
        eye = jnp.eye(dim, dtype=dtype)
        cov_new = (fg.raw + 5e-3 * eye) / (fg.weight + 5.0)
        chol_new = jnp.linalg.cholesky(cov_new)
        chol_ok = jnp.all(jnp.isfinite(chol_new))
        cov = jnp.where(do_refresh, cov_new, metric.cov)
        chol = jnp.where(do_refresh & chol_ok, chol_new, metric.chol)
    else:
        var = jnp.where(do_refresh, (fg.raw + 5e-3) / (fg.weight + 5.0),
                        metric.var)

    do_switch = delta >= metric.adapt_window
    zero = _zero_welford(dim, dtype, full)
    fg2 = jax.tree.map(lambda a, b: jnp.where(do_switch, b, a), fg, bg)
    bg2 = jax.tree.map(lambda a, b: jnp.where(do_switch, b, a), bg, zero)
    prev_update = jnp.where(do_switch, metric.n_samples, metric.prev_update)
    grown = metric.adapt_window * 2 if doubling else metric.adapt_window
    adapt_window = jnp.where(do_switch, grown, metric.adapt_window)
    n_samples = metric.n_samples + 1  # iteration-counted windows

    if full:
        new = FullMetricState(cov, chol, fg2, bg2, n_samples, prev_update,
                              adapt_window)
    else:
        new = DiagMetricState(var, fg2, bg2, n_samples, prev_update,
                              adapt_window)
    return jax.tree.map(lambda n, o: jnp.where(warmup, n, o), new, metric)
