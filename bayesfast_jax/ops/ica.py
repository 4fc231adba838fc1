"""FastICA on device.

The reference delegates to sklearn's FastICA (``transforms/sit.py:235-251``).
Here the whole algorithm — whitening via eigh, symmetric fixed-point
iteration with the logcosh nonlinearity, symmetric decorrelation — runs as
jitted XLA ops: the per-iteration work is a handful of (n, d) matmuls that
run as batched matrix products, and the fixed-point loop is a
``lax.while_loop``.
"""

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ['fast_ica']


def _sym_decorrelation(W):
    """W <- (W W^T)^{-1/2} W."""
    s, u = jnp.linalg.eigh(W @ W.T)
    s = jnp.maximum(s, 1e-12)
    return (u * (1.0 / jnp.sqrt(s))) @ u.T @ W


@partial(jax.jit, static_argnames=('max_iter',))
def _fast_ica_core(x, key, max_iter, tol):
    n, d = x.shape
    mean = jnp.mean(x, axis=0)
    xc = x - mean
    # whitening: cov = V diag(s) V^T ; K = diag(1/sqrt(s)) V^T
    cov = xc.T @ xc / n
    s, V = jnp.linalg.eigh(cov)
    s = jnp.maximum(s, 1e-18)
    K = (V / jnp.sqrt(s)).T  # (d, d)
    xw = xc @ K.T            # whitened, unit covariance

    W0 = _sym_decorrelation(jax.random.normal(key, (d, d), x.dtype))

    def body(carry):
        W, _, it = carry
        wx = xw @ W.T                       # (n, d)
        g = jnp.tanh(wx)
        g_prime = 1.0 - g * g
        W_new = (g.T @ xw) / n - jnp.mean(g_prime, axis=0)[:, None] * W
        W_new = _sym_decorrelation(W_new)
        lim = jnp.max(jnp.abs(jnp.abs(jnp.sum(W_new * W, axis=1)) - 1.0))
        return (W_new, lim, it + 1)

    def cond(carry):
        _, lim, it = carry
        return (lim > tol) & (it < max_iter)

    W, _, _ = jax.lax.while_loop(cond, body,
                                 (W0, jnp.asarray(jnp.inf, x.dtype),
                                  jnp.int32(0)))
    components = W @ K  # unmixing on centered data
    return components, mean


def fast_ica(x, key, max_iter=100, tol=1e-4):
    """Fit FastICA; returns ``(components, mean)`` with
    ``sources = (x - mean) @ components.T``."""
    x = jnp.asarray(x)
    return _fast_ica_core(x, key, int(max_iter), jnp.asarray(tol, x.dtype))
