"""Gaussian module tests (reference: ``bayesfast/tests/test_gaussian.py``)."""

import numpy as np
import jax
from scipy.stats import multivariate_normal

from bayesfast_jax.modules import Gaussian


def test_uni_gaussian():
    gaussian = Gaussian(0, 1, lower=None, upper=0)
    truth = multivariate_normal.logpdf(-2, 0, 1) + np.log(2)
    assert np.isclose(gaussian(-2)[0], truth).all()
    j_auto = jax.grad(lambda v: gaussian._fun(v))(np.float64(-2.0))
    assert np.isclose(gaussian.jac(-2)[0], np.asarray(j_auto)).all()


def test_diag_gaussian():
    gaussian = Gaussian(np.zeros(2), np.ones(2), lower=np.zeros(2),
                        upper=None)
    truth = (multivariate_normal.logpdf(np.ones(2), np.zeros(2), np.eye(2)) +
             np.log(4))
    assert np.isclose(gaussian(np.ones(2))[0], truth)
    j = gaussian.jac(np.ones(2))[0]
    assert np.allclose(j, -np.ones((1, 2)))


def test_multi_gaussian():
    cov = np.array([[1, 0.1], [0.1, 1]])
    gaussian = Gaussian(np.zeros(2), cov, lower=None, upper=None)
    truth = multivariate_normal.logpdf(np.ones(2), np.zeros(2), cov)
    assert np.isclose(gaussian(np.ones(2))[0], truth).all()
    j = gaussian.jac(np.ones(2))[0]
    j_true = -np.linalg.inv(cov) @ np.ones(2)
    assert np.allclose(j, j_true[None])


def test_truncated_full_cov():
    cov = np.array([[1, 0.3], [0.3, 1]])
    lower, upper = np.array([-1.0, -1.0]), np.array([2.0, 2.0])
    gaussian = Gaussian(np.zeros(2), cov, lower=lower, upper=upper)
    # normalization from large-sample MC
    rng = np.random.default_rng(1)
    pts = rng.multivariate_normal(np.zeros(2), cov, 200000)
    p = np.mean(np.all((pts >= lower) & (pts <= upper), axis=-1))
    truth = multivariate_normal.logpdf(np.array([0.5, 0.5]), np.zeros(2),
                                       cov) - np.log(p)
    assert np.isclose(gaussian(np.array([0.5, 0.5]))[0], truth, atol=0.01)
