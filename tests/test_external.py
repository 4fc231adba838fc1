"""External (non-traceable) likelihood support — the cosmosis/DES pattern:
the true model is host-only numpy, surrogate sampling stays on device."""

import numpy as np
import jax.numpy as jnp

import bayesfast_jax as bf
from bayesfast_jax.modules import PolyModel


# a 'black-box' numpy forward model (pretend it is an external pipeline)
def black_box_model(x, *args, **kwargs):
    x = np.asarray(x)
    return np.array([np.sum(x ** 2), np.sum(x) * 0.5])


def test_external_module_in_recipe():
    m_mod = bf.Module(fun=black_box_model, input_vars='x', output_vars='m',
                      input_shapes=[3], output_shapes=[2], traceable=False)
    lp_mod = bf.Module(fun=lambda m: -(m[0] - 4.0) ** 2 - m[1] ** 2,
                       input_vars='m', output_vars='logp')
    den = bf.Density(density_name='logp', module_list=[m_mod, lp_mod],
                     input_vars='x', input_shapes=[3],
                     decay_options={'use_decay': True})

    # host evaluation of the external model works (batched via callback)
    x = np.array([1.0, 1.0, 1.0])
    vd = den.fun(x, use_surrogate=False)
    assert np.isclose(vd.fun['m'][0], 3.0)
    assert np.isclose(vd.fun['logp'][0], -(3 - 4.0) ** 2 - 1.5 ** 2)
    vds = den.fun(np.stack([x, 2 * x]), use_surrogate=False)
    assert np.isclose(vds[1].fun['m'][0], 12.0)

    # surrogate workflow: fit on external evals, sample the surrogate
    surro = PolyModel('quadratic', input_size=3, output_size=2, scope=(0, 1),
                      input_vars='x', output_vars='m')
    den.surrogate_list = [surro]
    rng = np.random.default_rng(0)
    x_fit = rng.normal(size=(40, 3)) * 1.5
    den.fit(np.atleast_1d(den.fun(x_fit, use_surrogate=False)))
    lp_s = den.logp(x, use_surrogate=True)
    lp_t = den.logp(x, use_surrogate=False)
    assert np.isclose(lp_s, lp_t, rtol=1e-5)
    # gradients come from the surrogate (device), which the external model
    # cannot provide
    g = den.grad(x, use_surrogate=True)
    assert np.all(np.isfinite(g))

    bf.utils.set_generator(9)
    den.use_surrogate = True
    tt = bf.sample(den, {'n_chain': 4, 'n_iter': 500, 'n_warmup': 200},
                   verbose=False)
    assert np.all(np.isfinite(tt.get(flatten=True)))


def test_external_densitylite_logp():
    def ext_logp(x):
        return -0.5 * float(np.sum(np.asarray(x) ** 2))

    den = bf.DensityLite(logp=ext_logp, input_size=2, traceable=False)
    x = np.array([[1.0, 2.0], [0.5, -0.5]])
    lp = den.logp(x, original_space=True)
    assert np.allclose(lp, [-2.5, -0.25])


def test_external_evaluations_run_concurrently():
    """N slow external calls must overlap (the 64-process DES pattern,
    reference ``recipe.py:1085-1087``): wall time ~ 1 sleep, not N sleeps."""
    import time

    n, delay = 8, 0.25

    def slow_model(x):
        time.sleep(delay)
        return np.array([float(np.sum(np.asarray(x) ** 2))])

    m_mod = bf.Module(fun=slow_model, input_vars='x', output_vars='m',
                      input_shapes=[3], output_shapes=[1], traceable=False)
    lp_mod = bf.Module(fun=lambda m: -m[0], input_vars='m',
                       output_vars='logp')
    den = bf.Density(density_name='logp', module_list=[m_mod, lp_mod],
                     input_vars='x', input_shapes=[3])
    x = np.arange(3 * n, dtype=float).reshape(n, 3) * 0.1

    t0 = time.perf_counter()
    vds = den.fun(x, use_surrogate=False)
    dt_pipeline = time.perf_counter() - t0
    assert np.isclose(vds[1].fun['m'][0],
                      float(np.sum((x[1]) ** 2)), rtol=1e-5)
    assert dt_pipeline < n * delay * 0.5, \
        f'pipeline external eval not concurrent: {dt_pipeline:.2f}s'

    def slow_logp(x):
        time.sleep(delay)
        return -0.5 * float(np.sum(np.asarray(x) ** 2))

    lite = bf.DensityLite(logp=slow_logp, input_size=3, traceable=False)
    t0 = time.perf_counter()
    lp = lite.logp(x, original_space=True)
    dt_lite = time.perf_counter() - t0
    assert np.allclose(lp, -0.5 * np.sum(x ** 2, axis=-1), rtol=1e-5)
    assert dt_lite < n * delay * 0.5, \
        f'DensityLite external eval not concurrent: {dt_lite:.2f}s'
