"""Probability-density objects: constraint mixins and DensityLite.

Counterpart of ``bayesfast/core/density.py``. The reference threads
hand-written Jacobians through a numpy module loop; here densities are
JAX-traceable and gradients come from ``jax.value_and_grad`` of the *whole*
transformed log-density (to_original + log-Jacobian + user logp fused into a
single jitted function) — the reference's separate ``to_original_grad`` /
``grad2`` correction terms (``density.py:1044-1048``) collapse into autodiff,
and XLA fuses the constraint transform into the density kernel.

``Pipeline`` / ``Density`` (module-graph densities with surrogate
substitution) live in this file too, built on ``core.module``.
"""

import numpy as np
import jax
import jax.numpy as jnp

from ..config import get_dtype
from ..ops import constraint as _con

__all__ = ['Pipeline', 'Density', 'DensityLite']


def _as_scalar(v):
    """Coerce a logp value to a 0-d array WITHOUT a gratuitous reshape:
    ``jnp.reshape(x, ())`` on an already-scalar tracer still records a
    reshape op (and a scalar->scalar broadcast under the vmap transpose)."""
    v = jnp.asarray(v)
    return v if v.shape == () else v.reshape(())


class _PipelineBase:
    """Constraint-transform utilities shared by Pipeline/Density/DensityLite
    (``density.py:24-173``)."""

    @property
    def input_scales(self):
        return self._input_scales

    @input_scales.setter
    def input_scales(self, scales):
        self._input_scales = _con.normalize_scales(scales)

    @property
    def hard_bounds(self):
        return self._hard_bounds

    @hard_bounds.setter
    def hard_bounds(self, bounds):
        if isinstance(bounds, bool):
            self._hard_bounds = bounds
        else:
            self._hard_bounds = _con.normalize_bounds(
                bounds, np.atleast_1d(bounds).shape[0])

    @property
    def original_space(self):
        return self._original_space

    @original_space.setter
    def original_space(self, os):
        self._original_space = bool(os)

    # host transform API; accepts any leading batch shape. NumPy, not jnp:
    # these run on driver-side trace bookkeeping (whole-trace back-
    # transforms), where un-jitted op-by-op device execution would
    # round-trip the full batch between host and device once per op.
    def from_original(self, x):
        return np.asarray(_con.np_from_original(x, self._input_scales,
                                                self._hard_bounds))

    def from_original_grad(self, x):
        return np.asarray(_con.np_from_original_grad(x, self._input_scales,
                                                     self._hard_bounds))

    def from_original_grad2(self, x):
        return np.asarray(_con.np_from_original_grad2(
            x, self._input_scales, self._hard_bounds))

    def to_original(self, x):
        return np.asarray(_con.np_to_original(x, self._input_scales,
                                              self._hard_bounds))

    def to_original_grad(self, x):
        return np.asarray(_con.np_to_original_grad(x, self._input_scales,
                                                   self._hard_bounds))

    def to_original_grad2(self, x):
        return np.asarray(_con.np_to_original_grad2(x, self._input_scales,
                                                    self._hard_bounds))

    # traced (device) versions for use inside jitted code
    def _to_original_j(self, x):
        return _con.to_original(x, self._input_scales, self._hard_bounds)

    def _from_original_j(self, x):
        return _con.from_original(x, self._input_scales, self._hard_bounds)

    def _log_det_j(self, x_trans):
        """log |dx / dx_trans| evaluated at transformed coords."""
        g = _con.to_original_grad(x_trans, self._input_scales,
                                  self._hard_bounds)
        return jnp.sum(jnp.log(jnp.abs(g)), axis=-1)

    def _check_os_us(self, original_space, use_surrogate):
        original_space = (self.original_space if original_space is None
                          else bool(original_space))
        use_surrogate = (getattr(self, 'use_surrogate', False)
                         if use_surrogate is None else bool(use_surrogate))
        return original_space, use_surrogate


class _DensityBase:
    """Log-density transform corrections (``density.py:176-202``)."""

    def _get_diff(self, x=None, x_trans=None):
        # log |dx / dx_trans|
        if x is not None:
            return -np.sum(np.log(np.abs(self.from_original_grad(x))),
                           axis=-1)
        elif x_trans is not None:
            return np.sum(np.log(np.abs(self.to_original_grad(x_trans))),
                          axis=-1)
        raise ValueError('x and x_trans cannot both be None.')

    def to_original_density(self, density, x_trans=None, x=None):
        diff = self._get_diff(x, x_trans)
        density = np.asarray(density)
        if density.size != diff.size:
            raise ValueError('the shape of density is inconsistent with the '
                             'shape of x_trans or x.')
        return density - diff

    def from_original_density(self, density, x=None, x_trans=None):
        diff = self._get_diff(x, x_trans)
        density = np.asarray(density)
        if density.size != diff.size:
            raise ValueError('the shape of density is inconsistent with the '
                             'shape of x or x_trans.')
        return density + diff


class DensityLite(_PipelineBase, _DensityBase):
    """Directly wrap a JAX-traceable logp callable (``density.py:841-1131``).

    Parameters
    ----------
    logp : callable
        ``logp(x) -> scalar`` for a single 1-d point, written in JAX. The
        gradient is derived with ``jax.grad`` unless ``grad`` or
        ``logp_and_grad`` is supplied.
    grad, logp_and_grad : callable or None
        Optional explicit derivatives (must also be JAX-traceable).
    input_size : int or None
        Dimensionality; used to draw default starting points.
    input_scales, hard_bounds : see ``_PipelineBase``.
    original_space : bool
        Default interpretation of inputs.
    """

    def __init__(self, logp=None, grad=None, logp_and_grad=None,
                 input_size=None, input_scales=None, hard_bounds=False,
                 vectorized=False, original_space=True, traceable=True,
                 logp_args=(), logp_kwargs=None):
        self._logp = logp
        self._grad = grad
        self._logp_and_grad = logp_and_grad
        self._traceable = bool(traceable)
        self._logp_args = tuple(logp_args)
        self._logp_kwargs = dict(logp_kwargs or {})
        self.input_size = input_size
        self.input_scales = input_scales
        self.hard_bounds = hard_bounds
        self.vectorized = bool(vectorized)
        self.original_space = original_space
        self._jit_cache = {}

    # ------------- core single-point device functions -------------

    def _logp_1(self, x_o):
        """Single-point logp in original space (traced)."""
        if not self._traceable:
            # external (non-traceable) likelihood: host callback; not
            # differentiable — pair with surrogate sampling for gradients.
            # Under vmap the callback receives the whole batch at once
            # (vmap_method='expand_dims') and rows are dispatched over the
            # ParallelBackend thread pool, so N slow external calls overlap
            # instead of running serially.
            import numpy as _np

            def host_fn(xv):
                xv = _np.asarray(xv)
                one = lambda row: _np.asarray(
                    self._logp(_np.asarray(row), *self._logp_args,
                               **self._logp_kwargs), dtype=get_dtype())
                if xv.ndim == 1:
                    return one(xv).reshape(())
                from ..utils.parallel import get_backend
                lead = xv.shape[:-1]
                rows = xv.reshape((-1, xv.shape[-1]))
                vals = get_backend().map(one, list(rows))
                return _np.asarray(vals, dtype=get_dtype()).reshape(lead)

            return jax.pure_callback(
                host_fn, jax.ShapeDtypeStruct((), get_dtype()), x_o,
                vmap_method='expand_dims')
        if self._logp is not None:
            return _as_scalar(
                self._logp(x_o, *self._logp_args, **self._logp_kwargs))
        if self._logp_and_grad is not None:
            return _as_scalar(self._logp_and_grad(x_o)[0])
        raise RuntimeError('No valid definition of logp is found.')

    def _logp_trans_1(self, x_t):
        """Single-point logp in transformed space, with log-Jacobian.

        Uses the fused transform+logdet (one exp + one log, rational
        custom JVP) — the sampler hot path."""
        x_o, logdet = _con.to_original_with_logdet(
            x_t, self._input_scales, self._hard_bounds)
        return self._logp_1(x_o) + logdet

    def _logp_and_grad_1(self, x, original_space):
        f = self._logp_1 if original_space else self._logp_trans_1
        if self._logp_and_grad is not None and original_space:
            lp, g = self._logp_and_grad(x)
            return _as_scalar(lp), jnp.asarray(g)
        if (self._grad is not None and self._logp is not None
                and original_space):
            return f(x), jnp.asarray(self._grad(x))
        if not original_space and (self._grad is not None
                                   or self._logp_and_grad is not None):
            # explicit original-space grad + analytic transform corrections
            # (``density.py:1044-1048``)
            x_o = self._to_original_j(x)
            if self._logp_and_grad is not None:
                lp, g_o = self._logp_and_grad(x_o)
                lp = _as_scalar(lp)
            else:
                lp, g_o = self._logp_1(x_o), jnp.asarray(self._grad(x_o))
            tog = _con.to_original_grad(x, self._input_scales,
                                        self._hard_bounds)
            tog2 = _con.to_original_grad2(x, self._input_scales,
                                          self._hard_bounds)
            lp = lp + self._log_det_j(x)
            g = jnp.asarray(g_o) * tog + tog2 / tog
            return lp, g
        return jax.value_and_grad(f)(x)

    def current_params(self):
        """No runtime-mutable parameters for a plain DensityLite."""
        return ()

    def device_logp(self, original_space=False, use_surrogate=None):
        """Traceable scalar ``fn(x)`` (for optimizers / Laplace autodiff)."""
        if original_space:
            return self._logp_1
        return self._logp_trans_1

    def device_logp_and_grad(self, original_space=False, use_surrogate=None):
        """Return ``fn(params, x_1d) -> (logp, grad)`` for jitted kernels.

        ``params`` is ignored here; the signature matches ``Density`` so the
        sampler threads surrogate coefficients without recompiling.
        """
        def fn(params, x):
            return self._logp_and_grad_1(x, original_space)
        return fn

    # ------------- host-facing vectorized API -------------

    def _batched(self, kind, original_space):
        key = (kind, original_space)
        if key not in self._jit_cache:
            if kind == 'logp':
                # value-only path (works for non-differentiable callbacks)
                f = (self._logp_1 if original_space else self._logp_trans_1)
            elif kind == 'grad':
                f = lambda x: self._logp_and_grad_1(x, original_space)[1]
            else:
                f = lambda x: self._logp_and_grad_1(x, original_space)
            def call(x, f=f):
                x = jnp.asarray(x, get_dtype())
                if x.ndim == 1:
                    return f(x)
                flat = x.reshape((-1, x.shape[-1]))
                out = jax.vmap(f)(flat)
                resh = lambda o: o.reshape(x.shape[:-1] + o.shape[1:])
                return jax.tree.map(resh, out)
            self._jit_cache[key] = jax.jit(call)
        return self._jit_cache[key]

    def logp(self, x, original_space=None, use_surrogate=None):
        original_space, _ = self._check_os_us(original_space, use_surrogate)
        return np.asarray(self._batched('logp', original_space)(x))

    __call__ = logp

    def grad(self, x, original_space=None, use_surrogate=None):
        original_space, _ = self._check_os_us(original_space, use_surrogate)
        return np.asarray(self._batched('grad', original_space)(x))

    def logp_and_grad(self, x, original_space=None, use_surrogate=None):
        original_space, _ = self._check_os_us(original_space, use_surrogate)
        lp, g = self._batched('logp_and_grad', original_space)(x)
        return np.asarray(lp), np.asarray(g)

    @property
    def has_logp(self):
        return self._logp is not None

    @property
    def has_grad(self):
        return self._grad is not None

    @property
    def has_logp_and_grad(self):
        return self._logp_and_grad is not None

    @property
    def input_size(self):
        return self._input_size

    @input_size.setter
    def input_size(self, size):
        if size is None:
            self._input_size = None
        else:
            size = int(size)
            if size <= 0:
                raise ValueError('input_size should be a positive int, or '
                                 f'None, instead of {size}.')
            self._input_size = size

    @property
    def vectorized(self):
        return self._vectorized

    @vectorized.setter
    def vectorized(self, vec):
        self._vectorized = bool(vec)


# Pipeline and Density (module graphs + surrogates) are defined in
# core/pipeline.py and re-exported here once Phase 2 lands.
from .pipeline import Pipeline, Density  # noqa: E402,F401
