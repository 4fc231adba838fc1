"""Sliced Iterative Transform — a Gaussianizing normalizing flow fitted to
samples (``bayesfast/transforms/sit.py:28-459``).

Per iteration: (i) FastICA rotation (device, ``ops.ica``), (ii) per-dimension
1-d Gaussianization ``ndtri(KDE_cdf(x))`` approximated by a monotone cubic
spline. The reference farms the per-dim spline fits over a process pool
(``sit.py:230``); here the fits are a fast host loop (percentile/tridiagonal
numpy) while every bulk evaluation — forward/backward transforms, Jacobians,
spline inversion — runs as batched device kernels (``utils.cubic``), with all
dims of a layer evaluated by one kernel over padded knot arrays.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
from scipy.special import ndtri

from ..config import kde_on_device
from ..utils.kde import kde
from ..utils.cubic import cubic_spline, CubicSplineSet
from ..utils.sobol import multivariate_normal
from ..utils.random import get_generator, next_key
from ..ops.ica import fast_ica
from ..parallel.mesh import shard_batch

__all__ = ['SIT']


def _default_flow_dtype():
    """Dtype for on-device flow evaluation and the fit's data mirror.

    The spline fits consume float32 KDE-cdf values regardless of the run
    dtype, so on accelerators the flow runs float32 end-to-end (the
    log-Jacobian sum over ~L*D terms carries ~1e-4 absolute error — far
    below the evidence estimators' statistical errors); host-side
    inputs/outputs stay float64. On CPU the run dtype is kept. Whether
    float64 flows cost enough on the GPU to justify this is not measured.
    """
    if kde_on_device():
        return jnp.float32
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


@jax.jit
def _flow_forward(xs, cs, m, A, mu, x):
    """Full forward flow in one device program: ``lax.scan`` over the
    stacked layers. ``x`` is (n, D); returns (y, log_j) without the
    (host-side constant) sum of rotation log-dets."""
    from ..utils.cubic import _set_evaluate, _set_derivative

    def body(carry, layer):
        y, lj = carry
        xs_l, cs_l, m_l, A_l, mu_l = layer
        y = (y - mu_l) @ A_l.T
        yT = y.T
        der = _set_derivative(xs_l, cs_l, m_l, yT)
        lj = lj + jnp.sum(jnp.log(der), axis=0)
        y = _set_evaluate(xs_l, cs_l, m_l, yT).T
        return (y, lj), None

    lj0 = jnp.zeros(x.shape[0], x.dtype)
    (y, lj), _ = jax.lax.scan(body, (x, lj0), (xs, cs, m, A, mu))
    return y, lj


@jax.jit
def _flow_backward(xs, ys, cs, m, B, mu, y):
    """Full backward flow in one device program (layers in reverse)."""
    from ..utils.cubic import _set_solve, _set_derivative

    def body(carry, layer):
        x, lj = carry
        xs_l, ys_l, cs_l, m_l, B_l, mu_l = layer
        xT = _set_solve(xs_l, ys_l, cs_l, m_l, x.T)
        der = _set_derivative(xs_l, cs_l, m_l, xT)
        lj = lj + jnp.sum(jnp.log(der), axis=0)
        x = xT.T @ B_l.T + mu_l
        return (x, lj), None

    lj0 = jnp.zeros(y.shape[0], y.dtype)
    (x, lj), _ = jax.lax.scan(body, (y, lj0), (xs, ys, cs, m, B, mu),
                              reverse=True)
    return x, lj


from functools import partial


def _knot_stage_impl(y_T, w, bins, eb, edge_points):
    """Device stage A of the per-dim spline fits: percentile knots,
    edge-regression offsets, weighted KDE bandwidths, and the finite-row
    count — ONE small packed fetch replaces the 12 MB host data mirror,
    per-dim host percentiles and per-dim host bandwidth estimation.

    ``y_T`` is (D, N); ``w`` (N,) unnormalized weights. Returns a packed
    (D, n_q + 2 * edge_points + 2) array: [x0 | xe1 | xe2 | h | n_finite],
    with the same linear-interpolation percentile semantics as
    ``np.percentile`` on the host path.
    """
    D, N = y_T.shape
    finite = jnp.isfinite(y_T).all(axis=0)
    n_fin = jnp.sum(finite).astype(y_T.dtype)
    ys = jnp.sort(y_T, axis=1)
    qs = jnp.linspace(0.0, 100.0, bins + 1)[eb:-eb]
    x0 = jnp.percentile(y_T, qs, axis=1).T          # (D, n_q)

    ps = jnp.linspace(0.0, 100.0, edge_points + 2)[1:-1]

    def prefix_quantiles(row, count):
        # np.percentile('linear') over row[:count]
        pos = ps / 100.0 * (count - 1.0)
        lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, N - 1)
        hi = jnp.clip(lo + 1, 0, jnp.maximum(count - 1, 1).astype(jnp.int32))
        frac = pos - lo
        return row[lo] + (row[hi] - row[lo]) * frac

    def suffix_quantiles(row, count):
        pos = ps / 100.0 * (count - 1.0)
        base = N - count
        lo = jnp.floor(pos).astype(jnp.int32)
        hi = jnp.minimum(lo + 1, jnp.maximum(count - 1, 1).astype(jnp.int32))
        frac = pos - lo
        i_lo = jnp.clip(base + lo, 0, N - 1).astype(jnp.int32)
        i_hi = jnp.clip(base + hi, 0, N - 1).astype(jnp.int32)
        return row[i_lo] + (row[i_hi] - row[i_lo]) * frac

    def per_dim(row_sorted, x0_d):
        t1 = x0_d[eb]
        t2 = x0_d[-eb - 1]
        c1 = jnp.searchsorted(row_sorted, t1, side='left')
        c2 = N - jnp.searchsorted(row_sorted, t2, side='right')
        xe1 = prefix_quantiles(row_sorted, c1.astype(y_T.dtype)) - x0_d[0]
        xe2 = suffix_quantiles(row_sorted, c2.astype(y_T.dtype)) - x0_d[-1]
        return xe1, xe2

    xe1, xe2 = jax.vmap(per_dim)(ys, x0)

    # weighted Scott bandwidth per dim (``utils.kde.set_bandwidth``)
    wn = w / jnp.sum(w)
    neff = 1.0 / jnp.sum(wn * wn)
    mean = y_T @ wn
    diff = y_T - mean[:, None]
    cov = jnp.sum(diff * diff * wn[None, :], axis=1) / (
        1.0 - jnp.sum(wn * wn))
    h = jnp.sqrt(cov) * neff ** (-0.2)

    return jnp.concatenate(
        [x0, xe1, xe2, h[:, None],
         jnp.broadcast_to(n_fin, (D,))[:, None]], axis=1)


_knot_stage_device = partial(jax.jit, static_argnums=(2, 3, 4))(
    _knot_stage_impl)


@partial(jax.jit, static_argnums=(4, 5, 6))
def _ica_knot_fused(x_dev, components_dev, mean_dev, w, bins, eb,
                    edge_points):
    """Post-ICA rotation bookkeeping + stage-A knot work as ONE device
    program with ONE flattened output for a single host fetch.

    Every blocking fetch is a device round trip that also drains the
    queued async work; fusing the per-layer ICA pack and knot pack makes
    that one fetch per layer instead of two. Returns ``(y_dev, flat)``
    with ``flat`` =
    [components | mean | scale | data-mean | knot-pack], all float32.
    """
    y0 = (x_dev - mean_dev) @ components_dev.T
    s = jnp.std(y0, axis=0)
    y_dev = y0 / s
    m = jnp.mean(x_dev, axis=0)
    kp = _knot_stage_impl(y_dev.T, w, bins, eb, edge_points)
    icap = jnp.concatenate(
        [components_dev.astype(jnp.float32),
         mean_dev.astype(jnp.float32)[None],
         s.astype(jnp.float32)[None],
         m.astype(jnp.float32)[None]], axis=0)
    flat = jnp.concatenate([icap.reshape(-1),
                            kp.astype(jnp.float32).reshape(-1)])
    return y_dev, flat


class _NonFiniteLayer(Exception):
    """Raised when a layer's input contains non-finite rows (detected on
    device); ``SIT.fit`` drops them and reruns the layer."""


class SIT:
    """Sliced Iterative Transform generative model.

    Parameters mirror the reference; ``parallel_backend`` is accepted and
    ignored (per-dim work is batched on device instead of pool-mapped).
    """

    def __init__(self, n_iter=10, parallel_backend=None, bw_factor=1.,
                 m_ica=20000, random_generator=None, m_plot=8,
                 cubic_options=None, ica_options=None, mvn_generator=None,
                 flow_dtype=None):
        self._data = None
        self._spline_sets = []
        self.n_iter = n_iter
        self.flow_dtype = flow_dtype
        self.bw_factor = bw_factor
        self.m_ica = m_ica
        self.random_generator = random_generator
        self.m_plot = int(m_plot)
        self.cubic_options = dict(cubic_options or {})
        self.ica_options = dict(ica_options if ica_options is not None
                                else {'max_iter': 100})
        self.mvn_generator = (multivariate_normal if mvn_generator is None
                              else mvn_generator)

    @property
    def flow_dtype(self):
        """Dtype for on-device flow evaluation (see ``_default_flow_dtype``);
        ``None`` resolves per-call to the platform default."""
        if self._flow_dtype is None:
            return _default_flow_dtype()
        return self._flow_dtype

    @flow_dtype.setter
    def flow_dtype(self, dtype):
        self._flow_dtype = None if dtype is None else jnp.dtype(dtype)

    @property
    def data(self):
        return self._data

    @property
    def data_init(self):
        return self._data_init

    @property
    def dim(self):
        return self._data.shape[-1]

    @property
    def weights(self):
        return self._weights

    @property
    def n_iter(self):
        return self._n_iter

    @n_iter.setter
    def n_iter(self, n):
        n = int(n)
        if n <= 0:
            raise ValueError('n_iter should be a positive int.')
        self._n_iter = n

    @property
    def i_iter(self):
        return len(self._spline_sets)

    def add_iter(self, n):
        self.n_iter = self.n_iter + n

    @property
    def random_generator(self):
        if self._random_key is None:
            return get_generator()
        return self._random_key

    @random_generator.setter
    def random_generator(self, generator):
        if generator is None:
            self._random_key = None
        elif isinstance(generator, (int, np.integer)):
            self._random_key = jax.random.PRNGKey(int(generator))
        else:
            self._random_key = generator

    def _next_key(self):
        if self._random_key is None:
            return next_key()
        self._random_key, sub = jax.random.split(self._random_key)
        return sub

    # ------------- fitting -------------

    def _drain_icap(self):
        """Fetch the deferred fused ICA+knot pack (ONE host transfer);
        stores ``(A, B, m)`` in ``_fetched_icap`` and returns the knot
        pack (or None if no fused program is pending)."""
        pending = getattr(self, '_pending_icap', None)
        if pending is None:
            return None
        flat, D, edge_points = pending
        self._pending_icap = None
        buf = np.asarray(flat, np.float64)
        icap = buf[:(D + 3) * D].reshape(D + 3, D)
        kp = buf[(D + 3) * D:].reshape(D, -1)
        components, s, m = icap[:D], icap[D + 1], icap[D + 2]
        A = components / s[:, None]
        self._fetched_icap = (A, np.linalg.inv(A), m)
        return kp

    def _gaussianize_1d(self, x):
        """KDE-cdf -> ndtri -> monotone spline for one dimension
        (``sit.py:223-227``)."""
        k = kde(x, bw_factor=self.bw_factor, weights=self._weights)
        return cubic_spline(x, lambda xx: ndtri(k.cdf(xx)),
                            **self.cubic_options)

    def _fit_splines_device(self, y, y_dev=None):
        """All dims' spline fits with every bulk stage on device: the
        KDE-cdf sums run as ONE padded kernel per fit stage (see
        ``fit_spline_columns``), and the stage-A percentile knots, edge
        offsets and bandwidths come from ``_knot_stage_device`` as one
        small packed fetch — the host never touches the full data
        columns."""
        from ..ops.kde import kde_cdf_batch
        from ..utils.cubic import fit_spline_columns

        D = self.dim
        data_dev = (y_dev.T.astype(jnp.float32) if y_dev is not None
                    else jnp.asarray(np.asarray(y).T, jnp.float32))  # (D, N)
        w_dev = jnp.asarray(self._weights, jnp.float32)

        co = dict(self.cubic_options)
        bins = int(co.get('bins', 100))
        eb = min(int(co.get('edge_bins', 1)), bins // 4)
        edge_points = int(co.get('edge_points', 10))
        pack = self._drain_icap()   # fused per-layer fetch (fit loop)
        if pack is None:
            pack = np.asarray(_knot_stage_device(
                data_dev, w_dev, bins, eb, edge_points), np.float64)
        n_q = pack.shape[1] - 2 * edge_points - 2
        n_fin = int(pack[0, -1])
        if n_fin < data_dev.shape[1]:
            raise _NonFiniteLayer(data_dev.shape[1] - n_fin)
        hs = pack[:, -2] * self.bw_factor
        knots = []
        for d in range(D):
            x0 = np.unique(pack[d, :n_q])
            if x0.shape[0] < max(4, eb + 2):
                # collapsed/degenerate dim: rare — fetch just this column
                col = np.asarray(data_dev[d], np.float64)
                knots.append({'degenerate': col})
            else:
                knots.append({
                    'x0': x0,
                    'xe1': pack[d, n_q:n_q + edge_points],
                    'xe2': pack[d, n_q + edge_points:
                                n_q + 2 * edge_points]})
        h_dev = jnp.asarray(hs, jnp.float32)

        def fun_batch(queries):
            m = max(q.size for q in queries)
            if m == 0:
                return [np.empty(0) for _ in queries]
            m_pad = 128
            while m_pad < m:
                m_pad *= 2
            X = np.full((D, m_pad), 1e30)
            for d, q in enumerate(queries):
                X[d, :q.size] = q
            cdf = np.asarray(kde_cdf_batch(
                jnp.asarray(X, jnp.float32), data_dev, w_dev, h_dev),
                np.float64)
            # guard the float32 tails so ndtri stays finite (the knots are
            # inner percentiles, so this almost never binds)
            cdf = np.clip(cdf, 1e-10, 1.0 - 1e-7)
            return [ndtri(cdf[d, :q.size]) if q.size else np.empty(0)
                    for d, q in enumerate(queries)]

        return fit_spline_columns(None, fun_batch, knots=knots,
                                  **self.cubic_options)

    def _gaussianize_nd(self, y, y_dev=None):
        n_rows = (y_dev.shape[0] if y_dev is not None
                  else np.asarray(y).shape[0])
        device_fit = kde_on_device() and n_rows * self.dim >= 100_000
        if y is None and not device_fit:
            # _ica kept the data device-only, but the batch is too small
            # for the device fit: materialize the host mirror (and drain
            # the fused ICA fetch so fit() still gets A/B/m)
            self._drain_icap()
            y = np.asarray(y_dev, np.float64)
        if device_fit:
            splines = self._fit_splines_device(y, y_dev)
        else:
            # thread pool over dims: the per-dim fits spend their time in
            # the native KDE-cdf kernel and numpy (both GIL-releasing), so
            # threads scale with host cores — the in-process analog of the
            # reference farming per-dim fits over a process pool
            # (``sit.py:230``)
            from concurrent.futures import ThreadPoolExecutor
            import os as _os
            from ..native import bindings as _native
            n_workers = min(self.dim, _os.cpu_count() or 1)
            if n_workers > 1:
                _native.set_threads(1)  # one OMP lane per python thread
                try:
                    with ThreadPoolExecutor(n_workers) as ex:
                        splines = list(ex.map(
                            lambda i: self._gaussianize_1d(
                                np.asarray(y[:, i])),
                            range(self.dim)))
                finally:
                    _native.set_threads(0)
            else:
                splines = [self._gaussianize_1d(np.asarray(y[:, i]))
                           for i in range(self.dim)]
        sset = CubicSplineSet(splines, dtype=self.flow_dtype)
        self._spline_sets.append(sset)
        if device_fit:
            out_dev = sset.evaluate(y_dev.T if y_dev is not None
                                    else jnp.asarray(y).T).T
            # no host mirror: the next layer's stage-A runs on device too,
            # and ``fit`` fetches the final data once at the end
            return None, out_dev
        out = np.asarray(sset.evaluate(np.asarray(y).T)).T
        return out, None

    def _ica(self, x, x_dev=None):
        """FastICA rotation layer. ``x_dev`` (optional device mirror of
        ``x``) keeps the whole rotate step on device, so the data matrix
        is not shipped between host and device per layer. Returns
        ``(y, y_dev, A, B, m)``
        with ``y_dev`` None on the host path."""
        self._pending_icap = None    # drop any stale fused-fetch handle
        key = self._next_key()
        if x_dev is None and kde_on_device():
            x_dev = jnp.asarray(np.asarray(x), self.flow_dtype)
        n_rows = x_dev.shape[0] if x_dev is not None else np.asarray(x).shape[0]
        if self.m_ica is not None and n_rows > self.m_ica:
            idx = jax.random.choice(
                jax.random.fold_in(key, 1), n_rows, (self.m_ica,),
                replace=False)
            x_fit = (x_dev[idx] if x_dev is not None
                     else np.asarray(x)[np.asarray(idx)])
        else:
            x_fit = x_dev if x_dev is not None else x
        components_dev, mean_dev = fast_ica(
            x_fit, key, max_iter=self.ica_options.get('max_iter', 100),
            tol=self.ica_options.get('tol', 1e-4))
        if x_dev is not None:
            # fused post-ICA + stage-A knot program: ONE deferred fetch
            # (drained by ``_drain_icap``) instead of separate per-layer
            # ICA-pack and knot-pack fetches
            co = dict(self.cubic_options)
            bins = int(co.get('bins', 100))
            eb = min(int(co.get('edge_bins', 1)), bins // 4)
            edge_points = int(co.get('edge_points', 10))
            w_dev = jnp.asarray(self._weights, jnp.float32)
            y_dev, flat = _ica_knot_fused(
                x_dev.astype(self.flow_dtype), components_dev, mean_dev,
                w_dev, bins, eb, edge_points)
            self._pending_icap = (flat, x_dev.shape[1], edge_points)
            return None, y_dev, None, None, None
        else:
            x = np.asarray(x)
            components = np.asarray(components_dev, np.float64)
            mean = np.asarray(mean_dev, np.float64)
            y_dev = None
            y = (x - mean) @ components.T
            s = np.std(y, axis=0)
            y = y / s
            m = np.mean(x, axis=0)
        A = components / s[:, None]
        B = np.linalg.inv(A)
        return y, y_dev, A, B, m

    def _init_data(self, data, weights):
        if data is None:
            if self._data is None:
                raise ValueError('no fit data: pass data here or to a '
                                 'previous fit() call.')
            return
        data = np.array(data, np.float64)
        if data.ndim == 2:
            self._data = data
        elif data.ndim >= 3:
            self._data = data.reshape((-1, data.shape[-1]))
        else:
            raise ValueError('invalid shape for data.')
        self._data_init = self._data.copy()
        if self.dim == 1:
            raise ValueError('SIT needs at least 2 dimensions (the '
                             'ICA rotation is undefined in 1-d).')
        n = self._data.shape[0]
        if weights is not None:
            weights = np.asarray(weights)
            if weights.shape != (n,):
                raise ValueError('invalid value for weights.')
            self._weights = weights
        else:
            self._weights = np.ones(n) / n
        self._spline_sets = []
        self._A = np.zeros((0, self.dim, self.dim))
        self._B = np.zeros((0, self.dim, self.dim))
        self._m = np.zeros((0, self.dim))
        self._logdetA = np.zeros(0)

    def fit(self, data=None, weights=None, n_run=None, plot=0):
        """Fit ``n_run`` more Gaussianization layers (``sit.py:292-344``)."""
        self._init_data(data, weights)
        if n_run is None:
            n_run = self.n_iter - self.i_iter
        else:
            n_run = int(n_run)
            if n_run <= 0:
                raise ValueError('invalid value for n_run.')
            if n_run > self.n_iter - self.i_iter:
                self.n_iter = self.i_iter + n_run

        plot = int(plot)
        data_dev = None
        for _ in range(n_run):
            try:
                try:
                    y, y_dev, A, B, m = self._ica(self._data, data_dev)
                    data_new, data_dev = self._gaussianize_nd(y, y_dev)
                except _NonFiniteLayer:
                    raise
                except Exception:
                    warnings.warn(
                        'the ICA layer failed to converge; retrying once '
                        'with a fresh random seed.', RuntimeWarning)
                    y, y_dev, A, B, m = self._ica(self._data, data_dev)
                    data_new, data_dev = self._gaussianize_nd(y, y_dev)
            except _NonFiniteLayer:
                # non-finite rows detected on device (stage A of the
                # spline fits): drop them — the reference drops such
                # points with the same warning (``sit.py:334-340``) —
                # and rerun the layer on the filtered data
                warnings.warn('inf encountered for some data points. We '
                              'will remove these inf points for now.',
                              RuntimeWarning)
                data_host = (np.asarray(data_dev, np.float64)
                             if data_dev is not None else self._data)
                keep = np.isfinite(data_host).all(axis=1)
                self._data = data_host[keep]
                self._weights = self._weights[keep]
                data_dev = None
                y, y_dev, A, B, m = self._ica(self._data, data_dev)
                data_new, data_dev = self._gaussianize_nd(y, y_dev)
            if A is None:
                # device path defers the ICA bookkeeping into the fused
                # per-layer fetch; collect it now
                A, B, m = self._fetched_icap
            if data_new is not None:      # host path keeps a live mirror
                self._data = data_new
                finite_index = np.isfinite(self._data).all(axis=1)
                if np.sum(finite_index) < self._data.shape[0]:
                    warnings.warn('inf encountered for some data points. '
                                  'We will remove these inf points for '
                                  'now.', RuntimeWarning)
                    data_dev = None
                    self._data = self._data[finite_index, :]
                    self._weights = self._weights[finite_index]
            self._A = np.concatenate((self._A, A[np.newaxis]), axis=0)
            self._B = np.concatenate((self._B, B[np.newaxis]), axis=0)
            self._m = np.concatenate((self._m, m[np.newaxis]), axis=0)
            self._logdetA = np.append(
                self._logdetA, np.log(np.abs(np.linalg.det(A))))
            if plot > 0 and not (self.i_iter % plot):
                if data_new is None:
                    self._data = np.asarray(data_dev, np.float64)
                self.triangle_plot()
        if data_dev is not None:
            # device-resident layers: ONE final fetch of the gaussianized
            # data (it only feeds diagnostics and further fit() calls)
            self._data = np.asarray(data_dev, np.float64)
        if plot < 0:
            self.triangle_plot()

    # ------------- transforms -------------

    # rows per device pass: keeps the evidence phase (millions of proposal
    # points through 10+ flow layers) memory-bounded on a single device.
    # Byte-budgeted: each pass pays a fixed host<->device round trip, so
    # low-dimensional flows take correspondingly more rows per pass.
    _chunk_bytes = 1 << 25

    @property
    def _chunk_rows(self):
        return max(1 << 16, self._chunk_bytes // (8 * max(self.dim, 1)))

    def _stacked(self):
        """Stack every layer's padded spline set + rotation into (L, ...)
        device arrays (cached per layer count), so the whole multi-layer
        flow runs as ONE jitted ``lax.scan`` — a single host<->device
        round-trip per chunk instead of several per layer (the per-layer
        transfers dominated the evidence phase)."""
        if getattr(self, '_stk_n', -1) == self.i_iter:
            return self._stk
        L, D = self.i_iter, self.dim
        M = max(s.xs.shape[1] for s in self._spline_sets)
        xs = np.full((L, D, M), np.inf)
        ys = np.full((L, D, M), np.inf)
        cs = np.zeros((L, D, M + 1, 4))
        m = np.zeros((L, D), np.int32)
        # fill from the HOST spline objects (fetching the per-layer device
        # mirrors back costs one round trip per layer)
        for i, ss in enumerate(self._spline_sets):
            for d, s in enumerate(ss.splines):
                n = s._n
                xs[i, d, :n] = s._x
                ys[i, d, :n] = s._y
                cs[i, d, :n + 1] = s._c
                m[i, d] = n
        fdt = self.flow_dtype
        self._stk = dict(
            xs=jnp.asarray(xs, fdt), ys=jnp.asarray(ys, fdt),
            cs=jnp.asarray(cs, fdt), m=jnp.asarray(m),
            A=jnp.asarray(self._A, fdt), B=jnp.asarray(self._B, fdt),
            mu=jnp.asarray(self._m, fdt))
        self._stk_n = L
        return self._stk

    def forward_transform(self, x, use_parallel=False):
        """Data space -> latent (approximately N(0, I)); returns (y, log_j)
        (``sit.py:385-419``)."""
        y = np.array(x, np.float64)
        if y.ndim == 1:
            y = y[np.newaxis, :]
        if y.shape[-1] != self.dim:
            raise ValueError('invalid shape for x.')
        original_shape = y.shape
        y = y.reshape((-1, original_shape[-1]))
        if y.shape[0] > self._chunk_rows:
            outs = [self.forward_transform(y[o:o + self._chunk_rows])
                    for o in range(0, y.shape[0], self._chunk_rows)]
            return (np.concatenate([o[0] for o in outs]
                                   ).reshape(original_shape),
                    np.concatenate([o[1] for o in outs]
                                   ).reshape(original_shape[:-1]))
        if self.i_iter == 0:
            return (y.reshape(original_shape),
                    np.zeros(original_shape[:-1]))
        stk = self._stacked()
        yd, lj = _flow_forward(stk['xs'], stk['cs'], stk['m'], stk['A'],
                               stk['mu'],
                               shard_batch(jnp.asarray(y, self.flow_dtype)))
        y = np.asarray(yd, np.float64)
        log_j = np.asarray(lj, np.float64) + np.sum(self._logdetA)
        y = y.reshape(original_shape)
        log_j = log_j.reshape(original_shape[:-1])
        return y, log_j

    def backward_transform(self, y, use_parallel=False):
        """Latent -> data space; returns (x, log_j) (``sit.py:421-455``)."""
        x = np.array(y, np.float64)
        if x.ndim == 1:
            x = x[np.newaxis, :]
        if x.shape[-1] != self.dim:
            raise ValueError('invalid shape for y.')
        original_shape = x.shape
        x = x.reshape((-1, original_shape[-1]))
        if x.shape[0] > self._chunk_rows:
            outs = [self.backward_transform(x[o:o + self._chunk_rows])
                    for o in range(0, x.shape[0], self._chunk_rows)]
            return (np.concatenate([o[0] for o in outs]
                                   ).reshape(original_shape),
                    np.concatenate([o[1] for o in outs]
                                   ).reshape(original_shape[:-1]))
        if self.i_iter == 0:
            return (x.reshape(original_shape),
                    np.zeros(original_shape[:-1]))
        stk = self._stacked()
        xd, lj = _flow_backward(stk['xs'], stk['ys'], stk['cs'], stk['m'],
                                stk['B'], stk['mu'],
                                shard_batch(jnp.asarray(x, self.flow_dtype)))
        x = np.asarray(xd, np.float64)
        log_j = np.asarray(lj, np.float64) + np.sum(self._logdetA)
        x = x.reshape(original_shape)
        log_j = log_j.reshape(original_shape[:-1])
        return x, log_j

    def sample(self, n, use_parallel=False):
        """Draw ``n`` Sobol-normal latents and push back (``sit.py:366-374``)."""
        n = int(n)
        if n <= 0:
            raise ValueError('n should be a positive int.')
        y = self.mvn_generator(np.zeros(self.dim), np.eye(self.dim), n)
        x, log_j = self.backward_transform(y, use_parallel)
        return x, log_j, y

    def logq(self, x, use_parallel=False):
        """Model log-density: N(0,I) pullback (``sit.py:457-459``)."""
        y, log_j = self.forward_transform(x, use_parallel)
        const = -0.5 * np.log(2 * np.pi)
        return np.sum(const - 0.5 * y ** 2, axis=-1) + log_j

    def triangle_plot(self, show=True):
        """Corner plot of the current (partially Gaussianized) data —
        parity with ``sit.py:346-364``. Uses getdist when installed,
        otherwise a matplotlib fallback (1-d histograms on the diagonal,
        2-d histograms below); returns the figure."""
        if 0 < self.m_plot < self.dim:
            plot_data = self._data[:, :self.m_plot]
        else:
            plot_data = self._data
        title = (f'triangle plot after iteration {self.i_iter}'
                 if self.i_iter else 'triangle plot for the initial data')
        try:
            from getdist import plots, MCSamples
            import matplotlib.pyplot as plt
            samples = MCSamples(samples=plot_data)
            g = plots.getSubplotPlotter()
            g.triangle_plot([samples], filled=True,
                            contour_args={'alpha': 0.8},
                            diag1d_kwargs={'normalized': True})
            plt.suptitle(title, fontsize=plot_data.shape[-1] * 4, ha='left')
            fig = plt.gcf()
        except ImportError:
            import matplotlib.pyplot as plt
            d = plot_data.shape[-1]
            fig, axes = plt.subplots(d, d, figsize=(2 * d, 2 * d),
                                     squeeze=False)
            for i in range(d):
                for j in range(d):
                    ax = axes[i][j]
                    if j > i:
                        ax.set_axis_off()
                    elif i == j:
                        ax.hist(plot_data[:, i], bins=40, density=True,
                                histtype='step')
                    else:
                        ax.hist2d(plot_data[:, j], plot_data[:, i], bins=40,
                                  cmap='Blues')
                    if i < d - 1:
                        ax.set_xticklabels([])
                    if j > 0:
                        ax.set_yticklabels([])
            fig.suptitle(title)
            fig.tight_layout()
        if show:
            import matplotlib.pyplot as plt
            plt.show()
        return fig
