"""Pipeline/Density graph tests: module composition, surrogate substitution,
fitting from VariableDicts, and sampling a surrogate density."""

import numpy as np
import jax.numpy as jnp
import pytest

import bayesfast_jax as bf
from bayesfast_jax.core.module import Module
from bayesfast_jax.modules import PolyModel, Gaussian, Sum
from bayesfast_jax.utils.collections import VariableDict


def _donut_pipeline(use_surrogate_cfg=False):
    """2d-donut style: m = |x|^2 (expensive 'true model'), logp = -(m-4)^2."""
    m_mod = Module(fun=lambda x: jnp.sum(x ** 2), input_vars='x',
                   output_vars='m')
    lp_mod = Module(fun=lambda m: -(m - 4.0) ** 2, input_vars='m',
                    output_vars='logp')
    surro = PolyModel('quadratic', input_size=2, output_size=1, scope=(0, 1),
                      input_vars='x', output_vars='m',
                      bound_options={'use_bound': False})
    den = bf.Density(density_name='logp', module_list=[m_mod, lp_mod],
                     surrogate_list=[surro], input_vars='x',
                     input_shapes=[2])
    return den, surro


def test_pipeline_fun_and_jac():
    den, _ = _donut_pipeline()
    x = np.array([1.0, 2.0])
    vd = den.fun(x, use_surrogate=False)
    assert np.isclose(vd.fun['m'][0], 5.0)
    assert np.isclose(vd.fun['logp'][0], -1.0)
    vd2 = den.fun_and_jac(x, use_surrogate=False)
    # d logp / dx = -2 (m - 4) * 2x
    assert np.allclose(vd2.jac['logp'], [[-4.0, -8.0]])
    # batched evaluation
    xb = np.stack([x, 2 * x])
    vds = den.fun(xb, use_surrogate=False)
    assert vds.shape == (2,)
    assert np.isclose(vds[1].fun['m'][0], 20.0)


def test_density_logp_and_grad():
    den, _ = _donut_pipeline()
    x = np.array([0.5, -1.5])
    lp, g = den.logp_and_grad(x, use_surrogate=False)
    m = np.sum(x ** 2)
    assert np.isclose(lp, -(m - 4.0) ** 2)
    g_true = -2 * (m - 4.0) * 2 * x
    assert np.allclose(g, g_true)


def test_surrogate_substitution_and_fit():
    den, surro = _donut_pipeline()
    rng = np.random.default_rng(0)
    x_fit = rng.normal(size=(30, 2)) * 2
    var_dicts = den.fun(x_fit, use_surrogate=False)
    den.fit(var_dicts)
    # m = |x|^2 is exactly quadratic -> surrogate is exact
    x = np.array([1.2, -0.7])
    lp_true = den.logp(x, use_surrogate=False)
    lp_surro = den.logp(x, use_surrogate=True)
    assert np.isclose(lp_true, lp_surro, rtol=1e-6)
    g_true = den.grad(x, use_surrogate=False)
    g_surro = den.grad(x, use_surrogate=True)
    assert np.allclose(g_true, g_surro, rtol=1e-5)


def test_sample_surrogate_density():
    den, surro = _donut_pipeline()
    rng = np.random.default_rng(0)
    x_fit = rng.normal(size=(40, 2)) * 2.5
    den.fit(den.fun(x_fit, use_surrogate=False))
    den.use_surrogate = True
    bf.utils.set_generator(7)
    tt = bf.sample(den, {'n_chain': 4, 'n_iter': 1200, 'n_warmup': 400,
                         'x_0': rng.normal(size=(4, 2))}, verbose=False)
    s = tt.get(flatten=True)
    r = np.linalg.norm(s, axis=-1)
    # donut: radius concentrates around 2
    assert np.abs(np.mean(r) - 2.0) < 0.1
    assert np.all(np.abs(np.mean(s, axis=0)) < 0.2)


def test_gaussian_sum_graph():
    # two Gaussian blocks + Sum combining them, transformed-space check
    g1 = Gaussian(np.zeros(2), np.ones(2), input_vars='a', output_vars='lp1')
    g2 = Gaussian(np.ones(1), np.array([2.0]), input_vars='b',
                  output_vars='lp2')
    s = Sum(input_vars=['lp1', 'lp2'], output_vars='logp')
    den = bf.Density(density_name='logp', module_list=[g1, g2, s],
                     input_vars=['a', 'b'], input_shapes=[2, 1])
    x = np.array([0.3, -0.2, 1.4])
    lp, g = den.logp_and_grad(x)
    from scipy.stats import multivariate_normal
    lp_true = (multivariate_normal.logpdf(x[:2], np.zeros(2), np.eye(2)) +
               multivariate_normal.logpdf(x[2:], np.ones(1), 2 * np.eye(1)))
    assert np.isclose(lp, lp_true)
    g_true = np.concatenate([-x[:2], -(x[2:] - 1) / 2])
    assert np.allclose(g, g_true)


def test_delete_vars_and_scales():
    m1 = Module(fun=lambda x: 2.0 * x, input_vars='x', output_vars='y',
                input_scales=np.array([[0.0, 2.0]]))
    # input rescaled to (x-0)/2 then doubled -> y = x
    out = m1(np.array([1.5]))
    assert np.isclose(out[0][0], 1.5)
    j = m1.jac(np.array([1.5]))
    assert np.isclose(j[0][0, 0], 1.0)
