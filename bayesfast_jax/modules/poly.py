"""Polynomial surrogate model, batched on the device.

Counterpart of ``bayesfast/modules/poly.py`` + the 12 OpenMP Cython kernels in
``modules/_poly.pyx``. Architectural change: instead of packed coefficient
tensors walked by nested scalar loops (``_poly.pyx:13-137``), coefficients are
kept in the *least-squares monomial basis* and evaluation is a single feature
map + dense matmul

    y = A @ phi(x),   A: (output_size, n_features)

which runs as one matrix product and autodiff differentiates in one reverse
pass (the hand-written ``*_j`` kernels disappear). The feature orderings match
the reference's design-matrix builders exactly (``_lsq_quadratic`` k<=l
row-major, ``_lsq_cubic_2`` all (k,l) with x_k^2 x_l, ``_lsq_cubic_3``
combinations k<l<p), so fitted coefficients are directly comparable.

The fit solves *all* output dimensions sharing a recipe in one multi-RHS
lstsq (the reference loops over outputs serially, ``poly.py:529-587`` — 457
separate solves for the DES surrogate).

The Mahalanobis-bound linear extrapolation (``poly.py:480-503``) is kept
exactly, evaluated branch-free with ``jnp.where`` so thousands of chains stay
lockstep.
"""

from collections import namedtuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.module import Surrogate
from ..config import get_dtype

__all__ = ['PolyConfig', 'PolyModel']

BoundOptions = namedtuple('BoundOptions',
                          ('use_bound', 'alpha', 'alpha_p', 'center_max'))

_ORDERS = ('linear', 'quadratic', 'cubic-2', 'cubic-3')


def _feature_indices(order, n):
    """Monomial index arrays for one config, matching ``_poly.pyx:143-177``."""
    if order == 'linear':
        return None
    if order == 'quadratic':
        k, l = np.triu_indices(n)
        return (k, l)
    if order == 'cubic-2':
        k, l = np.mgrid[0:n, 0:n]
        return (k.reshape(-1), l.reshape(-1))
    if order == 'cubic-3':
        idx = np.array([(k, l, p) for k in range(n) for l in range(k + 1, n)
                        for p in range(l + 1, n)], dtype=int)
        if idx.size == 0:
            idx = idx.reshape(0, 3)
        return (idx[:, 0], idx[:, 1], idx[:, 2])
    raise ValueError(f'unexpected order {order}.')


def _n_features(order, n):
    """Independent coefficient count per output (``poly.py:110-129``)."""
    if order == 'linear':
        return n + 1
    if order == 'quadratic':
        return n * (n + 1) // 2
    if order == 'cubic-2':
        return n * n
    if order == 'cubic-3':
        return n * (n - 1) * (n - 2) // 6
    raise ValueError(f'unexpected order {order}.')


def _features(order, idx, x):
    """Feature vector phi(x) for one config; x is the masked input (n,)."""
    if order == 'linear':
        return jnp.concatenate([jnp.ones((1,), x.dtype), x])
    if order == 'quadratic':
        k, l = idx
        return x[k] * x[l]
    if order == 'cubic-2':
        k, l = idx
        return x[k] * x[k] * x[l]
    k, l, p = idx
    return x[k] * x[l] * x[p]


class PolyConfig:
    """One polynomial block (``poly.py:19-158``): order + input/output masks +
    coefficient matrix in the monomial basis."""

    def __init__(self, order, input_mask=None, output_mask=None):
        if order not in _ORDERS:
            raise ValueError(f'order should be one of {_ORDERS}, instead of '
                             f'"{order}".')
        self._order = order
        self._set_input_mask(input_mask)
        self._set_output_mask(output_mask)
        self._a = None      # (output_size, n_features) monomial coefficients
        self._idx = None

    @property
    def order(self):
        return self._order

    @property
    def input_mask(self):
        return self._input_mask

    def _set_input_mask(self, im):
        if im is None:
            self._input_mask = None
        else:
            self._input_mask = np.sort(np.unique(np.asarray(im, dtype=int)))
        self._idx = None

    @property
    def output_mask(self):
        return self._output_mask

    def _set_output_mask(self, om):
        if om is None:
            self._output_mask = None
        else:
            self._output_mask = np.sort(np.unique(np.asarray(om, dtype=int)))

    @property
    def input_size(self):
        return self._input_mask.size if self._input_mask is not None else None

    @property
    def output_size(self):
        return (self._output_mask.size if self._output_mask is not None
                else None)

    @property
    def _a_shape(self):
        return (_n_features(self._order, self.input_size),)

    @property
    def n_features(self):
        return _n_features(self._order, self.input_size)

    def _indices(self):
        if self._idx is None:
            self._idx = _feature_indices(self._order, self.input_size)
        return self._idx

    def _ensure_coef(self):
        if self._a is None:
            self._a = np.zeros((self.output_size, self.n_features))
        return self._a

    def _set(self, a, i):
        """Set the monomial coefficients of output row ``i``
        (``poly.py:131-158``; no repacking needed in this basis)."""
        a = np.asarray(a)
        if a.shape != self._a_shape:
            raise ValueError(f'shape of a {a.shape} does not match the '
                             f'expected shape {self._a_shape}.')
        i = int(i)
        if not 0 <= i < self.output_size:
            raise ValueError(f'i = {i} out of range.')
        self._ensure_coef()[i] = a

    def _phi(self, x_masked):
        return _features(self._order, self._indices(), x_masked)

    def _eval(self, a, x_full):
        """Traced: masked gather -> features -> matmul -> (output_size,)."""
        xm = x_full[jnp.asarray(self._input_mask)]
        return a @ self._phi(xm)


class PolyModel(Surrogate):
    """Polynomial surrogate (``poly.py:161-597``)."""

    def __init__(self, configs, bound_options=None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if isinstance(configs, str):
            try:
                upto = _ORDERS.index(configs)
            except ValueError:
                raise ValueError('if configs is a str, it should be "linear", '
                                 '"quadratic", "cubic-2" or "cubic-3".')
            configs = list(_ORDERS[:upto + 1])
        if isinstance(configs, PolyConfig):
            configs = [configs]
        if not hasattr(configs, '__iter__'):
            raise ValueError('invalid value for configs.')
        built = []
        for conf in configs:
            if isinstance(conf, str):
                conf = PolyConfig(conf)
            if not isinstance(conf, PolyConfig):
                raise ValueError('invalid element in configs.')
            if conf._input_mask is None:
                conf._set_input_mask(np.arange(self._input_size))
            if conf._output_mask is None:
                conf._set_output_mask(np.arange(self._output_size))
            built.append(conf)
        self._configs = tuple(built)
        self._build_recipe()
        self._mu = np.zeros(self._input_size)
        self._hess = np.eye(self._input_size)
        self._f_mu = np.zeros(self._output_size)
        self._alpha = None
        if bound_options is None:
            bound_options = {}
        if not isinstance(bound_options, dict):
            raise ValueError('bound_options should be a dict.')
        self.set_bound_options(**bound_options)

    @property
    def configs(self):
        return self._configs

    @property
    def n_config(self):
        return len(self._configs)

    @property
    def recipe(self):
        return self._recipe

    def _build_recipe(self):
        """Per-output (linear, quadratic, cubic-2, cubic-3) config table with
        overlap checks (``poly.py:298-337``)."""
        rr = np.full((self._output_size, 4), -1)
        for ii, conf in enumerate(self._configs):
            col = _ORDERS.index(conf.order)
            if np.any(rr[conf._output_mask, col] >= 0):
                raise ValueError(
                    f'multiple {conf.order} PolyConfig(s) share at least one '
                    f'common output variable. Please check your PolyConfig '
                    f'#{ii}.')
            rr[conf._output_mask, col] = ii
        if np.any(np.all(rr < 0, axis=1)):
            raise ValueError('no PolyConfig has output for variable(s) {}.'
                             .format(np.argwhere(np.all(rr < 0,
                                                        axis=1)).flatten()))
        self._recipe = rr

    # ------------- bound options (``poly.py:234-292``) -------------

    @property
    def bound_options(self):
        return BoundOptions(self._use_bound, self._alpha, self._alpha_p,
                            self._center_max)

    def set_bound_options(self, use_bound=True, alpha=None, alpha_p=100.,
                          center_max=True):
        self._use_bound = bool(use_bound)
        if alpha is not None:
            alpha = float(alpha)
            if alpha <= 0:
                raise ValueError('invalid value for alpha.')
            self._alpha = alpha
        if alpha_p is None:
            if alpha is None:
                raise ValueError('alpha and alpha_p cannot both be None.')
            self._alpha_p = None
        else:
            alpha_p = float(alpha_p)
            if alpha_p <= 0:
                raise ValueError('invalid value for alpha_p.')
            self._alpha_p = alpha_p
        self._center_max = bool(center_max)

    def _set_bound(self, x, logp=None):
        x = np.ascontiguousarray(x)
        self._mu = np.mean(x, axis=0)
        self._hess = np.linalg.inv(np.cov(x, rowvar=False))
        if self._alpha_p is not None:
            beta = np.einsum('ij,jk,ik->i', x - self._mu, self._hess,
                             x - self._mu) ** 0.5
            if self._alpha_p < 100.:
                self._alpha = np.percentile(beta, self._alpha_p)
            else:
                self._alpha = np.max(beta) * self._alpha_p / 100.
        if self._center_max and logp is not None:
            logp = np.asarray(logp)
            mu_f = x[np.argmax(logp)]
        else:
            mu_f = self._mu
        self._f_mu = np.asarray(self._eval_raw(self._coef_arrays(),
                                               jnp.asarray(mu_f, get_dtype())))

    # ------------- dynamic parameters -------------

    def _coef_arrays(self):
        dtype = get_dtype()
        return tuple(jnp.asarray(c._ensure_coef(), dtype)
                     for c in self._configs)

    def dynamic_params(self):
        dtype = get_dtype()
        alpha = np.inf if self._alpha is None else self._alpha
        return {
            'coefs': self._coef_arrays(),
            'mu': jnp.asarray(self._mu, dtype),
            'hess': jnp.asarray(self._hess, dtype),
            'alpha': jnp.asarray(alpha, dtype),
            'f_mu': jnp.asarray(self._f_mu, dtype),
        }

    # ------------- traced evaluation -------------

    def _eval_raw(self, coefs, x):
        """Sum of all config contributions, scatter-added over output masks
        (``poly.py:443-452``)."""
        out = jnp.zeros((self._output_size,), x.dtype)
        for conf, a in zip(self._configs, coefs):
            out = out.at[jnp.asarray(conf._output_mask)].add(
                conf._eval(a, x))
        return out

    def _fun_traced(self, ctx, x):
        params = ctx if ctx is not None else self.dynamic_params()
        coefs = params['coefs']
        if not self._use_bound or self._all_linear:
            return self._eval_raw(coefs, x)
        mu, hess, alpha, f_mu = (params['mu'], params['hess'],
                                 params['alpha'], params['f_mu'])
        delta = x - mu
        beta = jnp.sqrt(jnp.maximum(delta @ hess @ delta, 1e-30))
        inside = beta <= alpha
        # Linear extrapolation beyond the alpha-ellipsoid (``poly.py:480-496``),
        # branch-free. The unselected branch must stay finite because
        # d/dx where(c, a, b) evaluates both branch gradients: use safe
        # stand-ins (beta_safe=1 inside; alpha_safe=1 when alpha=inf pre-fit).
        alpha_safe = jnp.where(jnp.isfinite(alpha), alpha, 1.0)
        beta_safe = jnp.where(inside, 1.0, beta)
        x_0 = jnp.where(inside, x,
                        (alpha_safe * x + (beta_safe - alpha_safe) * mu)
                        / beta_safe)
        ff_0 = self._eval_raw(coefs, x_0)
        ff_out = (beta_safe * ff_0
                  - (beta_safe - alpha_safe) * f_mu) / alpha_safe
        return jnp.where(inside, ff_0, ff_out)

    # ------------- fitting -------------

    def fit(self, x, y, logp=None, w=None):
        """Least-squares fit of all configs (``poly.py:505-589``).

        Outputs sharing the same recipe row are solved in one multi-RHS
        lstsq on device.
        """
        x = np.asarray(x)
        y = np.asarray(y)
        if not (x.ndim == 2 and x.shape[-1] == self._input_size):
            raise ValueError(f'x should be (n_points, {self._input_size}), '
                             f'got {x.shape}.')
        if not (y.ndim == 2 and y.shape[-1] == self._output_size):
            raise ValueError(f'y should be (n_points, {self._output_size}), '
                             f'got {y.shape}.')
        if x.shape[0] != y.shape[0]:
            raise ValueError('x and y have different # of points.')
        if x.shape[0] < self.n_param:
            raise ValueError(f'I need at least {self.n_param} points, but you '
                             f'only gave me {x.shape[0]}.')
        if w is not None:
            w = np.atleast_1d(w)
            if not (w.ndim == 1 and w.shape[0] == x.shape[0]):
                raise ValueError('invalid shape for w.')

        dtype = get_dtype()
        xd = jnp.asarray(x, dtype)

        # group output dims by identical recipe rows -> shared design matrix
        rows = [tuple(r) for r in self._recipe]
        groups = {}
        for ii, r in enumerate(rows):
            groups.setdefault(r, []).append(ii)

        for row, out_idx in groups.items():
            conf_ids = [j for j in row if j >= 0]
            blocks = []
            widths = []
            for j in conf_ids:
                conf = self._configs[j]
                xm = xd[:, jnp.asarray(conf._input_mask)]
                phi = jax.vmap(conf._phi)(xm)
                blocks.append(phi)
                widths.append(phi.shape[1])
            A = jnp.concatenate(blocks, axis=1)
            B = jnp.asarray(y[:, out_idx], dtype)
            if w is not None:
                wj = jnp.asarray(w, dtype)
                A = A * wj[:, None]
                B = B * wj[:, None]
            sol = jnp.linalg.lstsq(A, B)[0]
            sol = np.asarray(sol)  # (n_feat_total, n_out_group)
            kk = np.cumsum([0] + widths)
            for bi, j in enumerate(conf_ids):
                conf = self._configs[j]
                block = sol[kk[bi]:kk[bi + 1]]
                for ci, ii in enumerate(out_idx):
                    qq = int(np.argwhere(conf._output_mask == ii)[0, 0])
                    conf._set(block[:, ci], qq)

        if self._use_bound and not self._all_linear:
            self._set_bound(x, logp)

    @property
    def n_param(self):
        return int(np.sum([conf.n_features for conf in self._configs]))

    @property
    def _all_linear(self):
        return all(conf.order == 'linear' for conf in self._configs)
