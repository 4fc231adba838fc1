"""End-to-end Recipe workflow test on a 2d-donut style density
(the reference's headline example, ``examples/2d-donut.ipynb``)."""

import numpy as np
import jax.numpy as jnp
import pytest

import bayesfast_jax as bf
from bayesfast_jax.core.module import Module
from bayesfast_jax.modules import PolyModel


def _make_density():
    # "expensive" module: m = |x|^2 ; cheap module: logp = -(m - 4)^2 / 0.5
    m_mod = Module(fun=lambda x: jnp.sum(x ** 2), input_vars='x',
                   output_vars='m')
    lp_mod = Module(fun=lambda m: -(m - 4.0) ** 2 / 0.5, input_vars='m',
                    output_vars='logp')
    # use_decay keeps the surrogate density proper outside the fit region
    # (the linear extrapolation alone has flat rays; ``density.py:756-811``)
    den = bf.Density(density_name='logp', module_list=[m_mod, lp_mod],
                     input_vars='x', input_shapes=[2],
                     decay_options={'use_decay': True})
    return den


def test_recipe_full_workflow():
    bf.utils.set_generator(11)
    den = _make_density()
    surro = PolyModel('quadratic', input_size=2, output_size=1, scope=(0, 1),
                      input_vars='x', output_vars='m')
    rng = np.random.default_rng(5)
    x_opt = rng.normal(size=(20, 2)) + 0.5  # keep away from the origin saddle
    rec = bf.Recipe(
        density=den,
        optimize={'surrogate_list': [surro], 'alpha_n': 3, 'x_0': x_opt,
                  'sample_trace': {'n_chain': 4, 'n_iter': 600,
                                   'n_warmup': 300}},
        sample={'surrogate_list': [surro], 'alpha_n': 3,
                'sample_trace': {'n_chain': 4, 'n_iter': 1000,
                                 'n_warmup': 400}},
        post={'n_is': 500},
    )
    rec.run()
    res = rec.get()

    # posterior: radius concentrated near 2
    r = np.linalg.norm(res.samples, axis=-1)
    w = res.weights_trunc
    r_mean = np.sum(r * w) / np.sum(w)
    assert abs(r_mean - 2.0) < 0.15

    # call budget: the whole point of the surrogate workflow — the true model
    # is evaluated only O(alpha_n * n_param * iters) + n_is times
    assert res.n_call is not None
    assert res.n_call < 700

    # IS weights: surrogate is exact inside the fit region (bulk of mass),
    # so the typical weight is ~1 (tails carry decay-penalty weights > 1)
    assert np.isclose(np.median(res.weights), 1.0, atol=0.1)
    assert np.all(np.isfinite(res.weights)) and np.all(res.weights > 0)

    f_opt, f_sam, f_pos = rec.recipe_trace.finished
    assert f_opt and f_sam and f_pos


def test_recipe_optimize_only_densitylite():
    bf.utils.set_generator(3)

    def logp(x):
        return -0.5 * jnp.sum((x - 1.5) ** 2)

    den = bf.DensityLite(logp=logp, input_size=3)
    rec = bf.Recipe(density=den, optimize={}, post=None)
    rec._opt_step()
    opt = rec.recipe_trace.results.optimize[-1]
    assert np.allclose(opt.x_max.x, 1.5, atol=1e-3)
    assert abs(opt.f_max.logp) < 1e-5
    # Laplace samples match the unit covariance at beta=100 tempering
    lap = opt.laplace_result
    assert np.allclose(lap.cov, np.eye(3), atol=1e-4)


def test_recipe_n_call_surrogate_free():
    """A SampleStep with no surrogates calls the true model inside the MCMC;
    RecipeTrace.n_call must tally those calls exactly from the trace
    (the reference raises NotImplementedError here, ``recipe.py:665-682``)."""
    bf.utils.set_generator(7)

    def logp(x):
        return -0.5 * jnp.sum(x ** 2)

    den = bf.DensityLite(logp=logp, input_size=2)
    rec = bf.Recipe(
        density=den,
        sample={'sample_trace': {'n_chain': 4, 'n_iter': 60,
                                 'n_warmup': 30}},
    )
    rec._sam_step()
    rt = rec.recipe_trace
    tt = rt.results.sample[-1].sample_trace
    assert rt.n_call == int(tt.n_call)
    assert rt.n_call > 4 * 60  # at least one call per chain-iteration
