"""Native host-library tests: C/OpenMP kernels vs numpy/device references."""

import numpy as np
import pytest

from bayesfast_jax import native
from bayesfast_jax.utils import sobol as sobol_mod
from bayesfast_jax.utils.cubic import cubic_spline


@pytest.fixture(scope='module')
def has_native():
    if not native.available():
        pytest.skip('bf_native could not be built on this host')
    return True


def test_native_sobol_matches_device(has_native):
    d, n = 12, 257
    V = sobol_mod.direction_numbers(d)
    pts = native.sobol_points(V, n, skip=1)
    ref = np.asarray(sobol_mod.uniform(np.zeros(d), np.ones(d), n, skip=1))
    assert np.allclose(pts, ref, atol=1e-7)


def test_native_kde_cdf(has_native):
    rng = np.random.default_rng(0)
    data = rng.normal(size=5000)
    w = np.full(5000, 1.0 / 5000)
    x = np.linspace(-3, 3, 101)
    got = native.kde_cdf(data, w, 0.3, x)
    from scipy.special import ndtr
    ref = ndtr((x[:, None] - data[None, :]) / 0.3) @ w
    assert np.allclose(got, ref, atol=1e-12)


def test_native_spline_roundtrip(has_native):
    rng = np.random.default_rng(1)
    sp = cubic_spline(rng.normal(size=4000) * 2, lambda x: np.arctan(x) + 0.2 * x)
    xt = np.linspace(-4, 4, 200)
    ev = native.spline_eval(sp._c, sp._x, xt)
    assert np.allclose(ev, sp.evaluate(xt), atol=1e-8)
    dv = native.spline_deriv(sp._c, sp._x, xt)
    assert np.allclose(dv, sp.derivative(xt), atol=1e-8)
    sol = native.spline_solve(sp._c, sp._x, sp._y, ev)
    assert np.allclose(sol, xt, atol=1e-6)
