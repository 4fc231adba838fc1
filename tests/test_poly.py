"""PolyModel tests (reference: ``bayesfast/tests/test_poly.py`` — exact
recovery of a known cubic polynomial), plus masked-config and bound tests."""

import numpy as np
import jax

import bayesfast_jax as bf
from bayesfast_jax.modules import PolyConfig, PolyModel

rng = np.random.default_rng(0)
x = rng.normal(size=(60, 4))


def poly_f(x):
    return (
        x[..., 0]**3 - 2 * x[..., 1]**3 + 3 * x[..., 1] * x[..., 2] * x[..., 3]
        - 4 * x[..., 2]**2 * x[..., 3] + 5 * x[..., 0]**2
        - 6 * x[..., 0] * x[..., 2] + 7 * x[..., 1] - 8
    )[..., np.newaxis]


def test_poly_exact_recovery():
    s = PolyModel('cubic-3', input_size=4, output_size=1,
                  bound_options={'use_bound': False})
    y = poly_f(x)
    s.fit(x, y)
    y_s = np.concatenate([s(x_i)[0] for x_i in x])
    assert np.allclose(y_s, y.flatten(), rtol=1e-6, atol=1e-6)
    # jacobian against autodiff of the true polynomial
    j_true = jax.grad(lambda v: poly_f(v[None])[0, 0])(x[0])
    j_s = s.jac(x[0])[0]
    assert np.allclose(j_s, np.asarray(j_true)[None], rtol=1e-5, atol=1e-5)


def test_poly_quadratic_recovery():
    def quad(v):
        return (2.0 * v[..., 0]**2 - v[..., 0] * v[..., 1] + 0.5 * v[..., 1]
                + 3.0)[..., np.newaxis]

    xq = rng.normal(size=(30, 2))
    s = PolyModel('quadratic', input_size=2, output_size=1,
                  bound_options={'use_bound': False})
    s.fit(xq, quad(xq))
    xt = rng.normal(size=(5, 2))
    y_s = np.array([s(v)[0][0] for v in xt])
    assert np.allclose(y_s, quad(xt).flatten(), rtol=1e-8)


def test_poly_masked_configs():
    # quadratic only on dims (0, 1); linear on all 3 dims; 2 outputs
    def f(v):
        return np.stack([
            v[..., 0]**2 + v[..., 0] * v[..., 1] + v[..., 2],
            2 * v[..., 1]**2 - v[..., 0] + 0.5,
        ], axis=-1)

    xq = rng.normal(size=(40, 3))
    configs = [PolyConfig('linear'),
               PolyConfig('quadratic', input_mask=[0, 1])]
    s = PolyModel(configs, input_size=3, output_size=2,
                  bound_options={'use_bound': False})
    s.fit(xq, f(xq))
    xt = rng.normal(size=(7, 3))
    y_s = np.array([s(v)[0] for v in xt])
    assert np.allclose(y_s, f(xt), rtol=1e-7, atol=1e-8)
    assert s.n_param == 4 + 3  # linear on 3 dims + quadratic on 2 dims


def test_poly_bound_extrapolation():
    # outside the alpha-ellipsoid the model extends linearly along rays
    def quad(v):
        return (v[..., 0]**2 + v[..., 1]**2)[..., np.newaxis]

    xq = rng.normal(size=(50, 2))
    s = PolyModel('quadratic', input_size=2, output_size=1,
                  bound_options={'use_bound': True, 'alpha_p': 100.})
    s.fit(xq, quad(xq), logp=-quad(xq).flatten())
    far = np.array([50.0, 0.0])
    y_far = s(far)[0][0]
    # linear extrapolation: much smaller than the quadratic's 2500
    assert y_far < 1500.0
    # gradient remains finite and consistent with a linear continuation
    j_far = s.jac(far)[0]
    assert np.all(np.isfinite(j_far))
    # value and jacobian continuous at the boundary: compare close points
    alpha = s.bound_options.alpha
    mu = s._mu
    direction = np.array([1.0, 0.3])
    direction /= np.sqrt(direction @ s._hess @ direction)
    x_in = mu + direction * (alpha * 0.999)
    x_out = mu + direction * (alpha * 1.001)
    assert np.isclose(s(x_in)[0][0], s(x_out)[0][0], rtol=1e-2)


def test_poly_multi_rhs_grouped_fit():
    # many outputs sharing one recipe solve in a single lstsq
    def f(v):
        return np.stack([v[..., 0]**2 + i * v[..., 1] for i in range(5)],
                        axis=-1)

    xq = rng.normal(size=(40, 2))
    s = PolyModel('quadratic', input_size=2, output_size=5,
                  bound_options={'use_bound': False})
    s.fit(xq, f(xq))
    xt = rng.normal(size=(3, 2))
    y_s = np.array([s(v)[0] for v in xt])
    assert np.allclose(y_s, f(xt), rtol=1e-7, atol=1e-8)
