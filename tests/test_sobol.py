"""Golden-value Sobol tests (reference: ``bayesfast/tests/test_sobol.py``)."""

import numpy as np

from bayesfast_jax.utils import sobol


def test_sobol_1d_golden():
    # first 4 points of the 1-d sequence after skipping the zero point
    f = sobol.uniform(0, 1, 4)
    assert np.allclose(f.T, [0.5, 0.75, 0.25, 0.375])


def test_sobol_uniform_range():
    f = sobol.uniform(np.full(5, -2.0), np.full(5, 3.0), 64)
    assert f.shape == (64, 5)
    assert (f >= -2).all() and (f <= 3).all()
    # Sobol points are distinct
    assert len(np.unique(f[:, 0])) == 64


def test_sobol_higher_dims_balance():
    # each dimension of a 2^k block is balanced around 1/2
    f = sobol.uniform(np.zeros(50), np.ones(50), 256, skip=256)
    assert np.allclose(f.mean(axis=0), 0.5, atol=0.01)


def test_sobol_matches_reference_recursion():
    # re-derive points with the direct XOR recursion on the direction numbers
    d, n = 8, 33
    V = sobol.direction_numbers(d)
    X = np.zeros(d, np.uint32)
    pts = [X.copy()]
    for i in range(1, n):
        c = 0
        value = i - 1
        while value & 1:
            value >>= 1
            c += 1
        X = X ^ V[:, c]
        pts.append(X.copy())
    expected = np.asarray(pts, np.float64) / 2.0**32
    got = sobol.uniform(np.zeros(d), np.ones(d), n, skip=0)
    assert np.allclose(got, expected)


def test_multivariate_normal_moments():
    mean = np.array([1.0, -2.0, 0.5])
    cov = np.array([[2.0, 0.5, 0.1], [0.5, 1.0, -0.2], [0.1, -0.2, 0.7]])
    x = sobol.multivariate_normal(mean, cov, 4096)
    assert np.allclose(x.mean(axis=0), mean, atol=0.02)
    assert np.allclose(np.cov(x, rowvar=False), cov, atol=0.05)
