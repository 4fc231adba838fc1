"""Unit tests for the remaining utility components: Laplace, systematic
resampling, make_positive, autocorrelation time / ESS, collections."""

import numpy as np
import bayesfast_jax as bf
import warnings
import pytest

from bayesfast_jax.utils import (Laplace, SystematicResampler, make_positive,
                                 integrated_time)
from bayesfast_jax.utils.acor import effective_sample_size, AutocorrError
from bayesfast_jax.utils.collections import VariableDict, PropertyList


def test_laplace_gaussian():
    import jax.numpy as jnp
    cov = np.array([[2.0, 0.5], [0.5, 1.0]])
    prec = np.linalg.inv(cov)

    def logp_tr(x):
        d = x - jnp.asarray([1.0, -2.0])
        return -0.5 * d @ jnp.asarray(prec) @ d

    def logp(x):
        return float(logp_tr(jnp.asarray(x)))

    lap = Laplace(beta=1.0, n_sample=4000)
    res = lap.run(logp, np.zeros(2), traceable=logp_tr)
    assert np.allclose(res.x_max, [1.0, -2.0], atol=1e-4)
    assert np.allclose(res.cov, cov, atol=1e-4)
    assert np.allclose(np.cov(res.samples, rowvar=False), cov, atol=0.1)

    # tempered run + untempering (``laplace.py:185-205``)
    lap_t = Laplace(beta=100.0, n_sample=4000)
    res_t = lap_t.run(logp, np.zeros(2), traceable=logp_tr)
    assert np.allclose(np.cov(res_t.samples, rowvar=False), cov / 100,
                       atol=0.01)
    unt = Laplace.untemper_laplace_samples(res_t)
    assert np.allclose(np.cov(unt, rowvar=False), cov, atol=0.15)


def test_make_positive():
    A = np.diag([1e-12, 1.0, 5.0])
    B = make_positive(A, max_cond=100.0)
    w = np.linalg.eigvalsh(B)
    assert w.min() >= 5.0 / 100.0 - 1e-12
    with pytest.raises(ValueError):
        make_positive(-np.eye(2))


def test_systematic_resampler():
    rng = np.random.default_rng(0)
    a = rng.normal(size=1000)
    rs = SystematicResampler()
    idx = rs.run(a, 100)
    assert idx.shape == (100,)
    # resampled values span the 1st-100th percentile range by rank
    vals = np.sort(a[idx])
    assert vals[-1] == np.max(a)
    assert vals[0] <= np.percentile(a, 2)
    # non-unique request raises
    with pytest.raises(RuntimeError):
        rs.run(a[:50], 200)


def test_integrated_time_and_ess():
    rng = np.random.default_rng(1)
    # AR(1) with known tau = (1+rho)/(1-rho)
    rho = 0.9
    n = 200000
    x = np.empty(n)
    x[0] = 0
    eps = rng.normal(size=n)
    for i in range(1, n):
        x[i] = rho * x[i - 1] + eps[i]
    tau = integrated_time(x, quiet=True)[0]
    tau_true = (1 + rho) / (1 - rho)
    assert abs(tau - tau_true) / tau_true < 0.15
    ess = effective_sample_size(x)
    assert abs(ess[0] - n / tau_true) / (n / tau_true) < 0.2
    # short-chain error path
    with pytest.raises(AutocorrError):
        integrated_time(x[:100])


def test_variable_dict_and_property_list():
    vd = VariableDict()
    vd['a'] = (np.arange(3), np.eye(3))
    fun, jac = vd['a']
    assert np.array_equal(fun, np.arange(3))
    assert np.array_equal(jac, np.eye(3))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        vd['missing']
        assert any('neither' in str(x.message) for x in w)
    assert np.array_equal(VariableDict.get([vd, vd], 'a', 'fun')[1],
                          np.arange(3))

    calls = []
    def check(lst):
        calls.append(len(lst))
        return lst
    pl = PropertyList([1, 2], check)
    pl.append(3)
    assert list(pl) == [1, 2, 3]
    assert len(calls) >= 2
    pl[0] = 5
    assert pl[0] == 5


def test_cubic_spline_degenerate_fallback():
    """Exactly-degenerate 1-d data must fall back to an affine map instead
    of crashing (the reference raises IndexError in this case)."""
    from bayesfast_jax.utils.cubic import cubic_spline
    x = np.full(500, 2.5)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        cs = cubic_spline(x, lambda xx: xx)
    out = cs.evaluate(np.array([2.5]))
    assert np.all(np.isfinite(out))
    assert np.all(cs.derivative(np.array([2.5])) > 0)
    # inverse round-trips through the affine map
    assert np.allclose(cs.solve(cs.evaluate(np.array([2.5]))), 2.5)


def test_metric_variance_floor():
    """Identical samples across a full adaptation window must not collapse
    the adapted variance to exactly zero (which would mean infinite
    momenta and a permanently dead chain)."""
    import jax.numpy as jnp
    from bayesfast_jax.samplers.metrics import (init_diag_metric,
                                                update_metric)
    m = init_diag_metric(jnp.zeros(3), jnp.ones(3))
    x = jnp.full((3,), 1.7)
    for _ in range(130):  # beyond the first 60-sample window switch
        m = update_metric(m, x, True)
    assert np.all(np.asarray(m.var) > 0)


def test_rhat():
    from bayesfast_jax.utils import rhat
    rng = np.random.default_rng(0)
    # well-mixed chains: rhat ~ 1
    good = rng.normal(size=(4, 500, 3))
    r = rhat(good)
    assert r.shape == (3,)
    assert np.all(r < 1.02)
    # diverged means: rhat >> 1
    bad = good.copy()
    bad[0] += 5.0
    assert np.all(rhat(bad) > 1.5)
    # 2-d input gives a scalar
    assert np.isscalar(rhat(good[:, :, 0]))


def test_kde_resample():
    """kde.resample draws from the estimated density (reference
    ``kde.py:356-381``): mean/cov of draws match data mean and
    cov + kernel covariance."""
    from bayesfast_jax.utils.kde import kde
    rng = np.random.default_rng(0)
    data = rng.normal(size=(4000, 2)) @ np.array([[1.0, 0.4], [0.0, 0.7]])
    k = kde(data)
    bf.utils.set_generator(123)
    draws = k.resample(20000)
    assert draws.shape == (20000, 2)
    target_cov = np.cov(data.T) + k.covariance
    assert np.allclose(np.mean(draws, axis=0), np.mean(data, axis=0),
                       atol=0.05)
    assert np.allclose(np.cov(draws.T), target_cov, atol=0.08)
    # default size = effective sample size
    assert k.resample().shape == (int(k.neff), 2)


def test_cubic_inverse_near_flat_segment():
    """Round-4 advisor: when Newton steps are rejected (df ~ 0 in near-flat
    monotone regions, e.g. KDE-CDF tails), each sweep degrades to one
    bisection; the sweep count must still deliver high inverse accuracy."""
    from bayesfast_jax.utils.cubic import cubic_spline

    # error-function-like data: extremely flat tails, steep center
    xs = np.linspace(-8.0, 8.0, 2001)
    cs = cubic_spline(xs, lambda xx: np.tanh(3.0 * xx)
                      + 1e-3 * xx)
    x_test = np.concatenate([np.linspace(-7.5, -3.0, 200),   # flat tail
                             np.linspace(-0.5, 0.5, 100),    # steep
                             np.linspace(3.0, 7.5, 200)])    # flat tail
    y = np.asarray(cs.evaluate(x_test))
    x_rec = np.asarray(cs.solve(y))
    # round-trip through the flat tails: |dy/dx| ~ 1e-3 there, so x error
    # = y-solve error / slope; require well under one knot spacing
    np.testing.assert_allclose(x_rec, x_test, atol=2e-6)


class _MockDistributedExecutor:
    """Mock of a multi-node Executor (dask ClientExecutor / mpi4py
    MPIPoolExecutor shape): implements submit/map/shutdown over a thread
    pool while recording every dispatch, so the test can assert the
    framework routed its external work through the injected executor."""

    def __init__(self):
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(4)
        self.n_submits = 0

    def submit(self, fn, *args, **kwargs):
        self.n_submits += 1
        return self._pool.submit(fn, *args, **kwargs)

    def map(self, fn, *iterables, timeout=None, chunksize=1):
        items = list(zip(*iterables))
        self.n_submits += len(items)
        futs = [self._pool.submit(fn, *a) for a in items]
        return (f.result() for f in futs)

    def shutdown(self, wait=True, cancel_futures=False):
        self._pool.shutdown(wait=wait)


def test_injected_executor_backend():
    """The multi-node story is Executor injection —
    any conforming concurrent.futures.Executor (dask ClientExecutor,
    mpi4py MPIPoolExecutor, a ray adapter) drops in via set_backend and
    receives the framework's external-likelihood dispatches."""
    import jax.numpy as jnp
    import bayesfast_jax as bf
    from bayesfast_jax.utils.parallel import (ParallelBackend, get_backend,
                                              set_backend)
    from concurrent.futures import Executor

    assert issubclass(_MockDistributedExecutor, object)
    ex = _MockDistributedExecutor()
    prev = get_backend()
    try:
        set_backend(ex if isinstance(ex, Executor) else
                    ParallelBackend(backend=None))
        # ParallelBackend accepts raw Executors directly
        set_backend(ParallelBackend(ex))
        b = get_backend()
        assert b.kind == 'executor'
        out = b.map(np.square, [np.arange(3), np.arange(4)])
        assert np.array_equal(out[1], np.arange(4) ** 2)
        assert ex.n_submits >= 2

        # end to end: an external (non-traceable) module's batch dispatch
        # rides the injected executor
        def ext_logp(x):
            return np.array([-float(np.sum(np.asarray(x) ** 2))])

        mod = bf.Module(fun=ext_logp, input_vars='x', output_vars='logp',
                        input_shapes=[3], output_shapes=[1],
                        traceable=False)
        den = bf.Density(density_name='logp', module_list=[mod],
                         input_vars='x', input_shapes=[3])
        before = ex.n_submits
        x = np.random.default_rng(0).normal(size=(6, 3))
        vds = den.fun(x, use_surrogate=False)
        assert len(vds) == 6
        assert ex.n_submits > before
    finally:
        set_backend(prev)
        ex.shutdown()
