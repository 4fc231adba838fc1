"""End-to-end statistical tests of the batched NUTS/HMC samplers.

The reference has no integration tests (SURVEY.md §4) — its notebooks play
that role. Here we add seeded statistical checks: posterior moments within
Monte-Carlo error on analytically known densities, plus the sharded-mesh
path on the 8-device CPU mesh.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import bayesfast_jax as bf
from bayesfast_jax.parallel import make_mesh, set_mesh


@pytest.fixture(autouse=True)
def _seed():
    bf.utils.set_generator(0)
    yield
    set_mesh(None)


def _gauss_density(dim=4):
    rng = np.random.default_rng(3)
    A = rng.normal(size=(dim, dim))
    cov = A @ A.T / dim + np.eye(dim)
    prec = jnp.asarray(np.linalg.inv(cov))

    def logp(x):
        return -0.5 * x @ prec @ x

    return bf.DensityLite(logp=logp, input_size=dim), cov


def test_nuts_gaussian_moments():
    den, cov = _gauss_density()
    tt = bf.sample(den, {'n_chain': 8, 'n_iter': 1500, 'n_warmup': 500},
                   verbose=False)
    s = tt.get(flatten=True)
    assert s.shape == (8 * 1000, 4)
    se = np.sqrt(np.diag(cov) / 500)  # generous MC error floor
    assert np.all(np.abs(s.mean(axis=0)) < 5 * se)
    assert np.abs(np.cov(s, rowvar=False) - cov).max() < 0.25
    # divergence-free on a Gaussian
    st = tt[0].stats.get()
    assert np.sum(st['diverging']) == 0
    assert 0.6 < np.mean(st['mean_tree_accept']) < 1.0


def test_hmc_gaussian_moments():
    den, cov = _gauss_density()
    tt = bf.sample(den, {'n_chain': 8, 'n_iter': 3000, 'n_warmup': 1000,
                         'n_int_step': 24}, sampler='HMC', verbose=False)
    s = tt.get(flatten=True)
    # fixed-length HMC mixes slower than NUTS; looser tolerance
    assert np.abs(np.cov(s, rowvar=False) - cov).max() < 0.6
    assert np.abs(s.mean(axis=0)).max() < 0.25
    assert tt.sampler == 'HMC'
    # exact accounting: iterations + initial state + the start-descent and
    # step-probe evaluations recorded by the trace
    assert tt.trace._descent_calls > 0
    assert tt.n_call == 8 * (3000 * 25 + 1) + tt.trace._descent_calls


def test_full_metric_adaptation():
    den, cov = _gauss_density()
    tt = bf.sample(den, {'n_chain': 8, 'n_iter': 1200, 'n_warmup': 500,
                         'metric': 'full'}, verbose=False)
    s = tt.get(flatten=True)
    assert np.abs(np.cov(s, rowvar=False) - cov).max() < 0.3


def test_bounded_density():
    # x ~ Beta(2, 3)-like density on (0, 1), sampled in logit space
    def logp(x):
        return jnp.sum(1.0 * jnp.log(x) + 2.0 * jnp.log1p(-x))

    den = bf.DensityLite(logp=logp, input_size=2,
                         input_scales=np.array([[0., 1.], [0., 1.]]),
                         hard_bounds=True)
    tt = bf.sample(den, {'n_chain': 4, 'n_iter': 2000, 'n_warmup': 500},
                   verbose=False)
    s = tt.get(flatten=True)
    assert (s > 0).all() and (s < 1).all()
    # Beta(2,3): mean 0.4, var 0.04
    assert np.allclose(s.mean(axis=0), 0.4, atol=0.03)
    assert np.allclose(s.var(axis=0), 0.04, atol=0.01)


def test_sharded_chains_on_mesh():
    set_mesh(make_mesh())
    den, cov = _gauss_density()
    tt = bf.sample(den, {'n_chain': 16, 'n_iter': 800, 'n_warmup': 300},
                   verbose=False)
    s = tt.get(flatten=True)
    assert s.shape == (16 * 500, 4)
    assert np.abs(np.cov(s, rowvar=False) - cov).max() < 0.3


def test_continuation_add_iter():
    den, _ = _gauss_density()
    tt = bf.sample(den, {'n_chain': 4, 'n_iter': 600, 'n_warmup': 300},
                   verbose=False)
    assert tt.i_iter == 600
    tt.trace.add_iter(400)
    tt2 = bf.sample(den, tt, verbose=False)
    assert tt2.i_iter == 1000
    assert tt2.get(flatten=False).shape == (4, 700, 4)


def test_funnel_target_accept():
    # Neal funnel D=4: x0 ~ N(0, 9), x_i | x0 ~ N(0, exp(x0))
    def logp(x):
        v = x[0]
        lp = -0.5 * v * v / 9.0 - 0.5 * np.log(2 * np.pi * 9.0)
        lp += jnp.sum(-0.5 * x[1:] ** 2 * jnp.exp(-v) - 0.5 * (v + np.log(2 * np.pi)))
        return lp

    den = bf.DensityLite(logp=logp, input_size=4)
    tt = bf.sample(den, {'n_chain': 8, 'n_iter': 3000, 'n_warmup': 1000,
                         'target_accept': 0.95}, verbose=False)
    s = tt.get(flatten=True)
    # The centered funnel is a known-hard geometry (even Stan's NUTS shows
    # O(0.5) bias on the v marginal); this is a sanity check that the neck
    # is explored at all, not an exactness test.
    assert np.abs(s[:, 0].mean()) < 1.0
    assert np.abs(s[:, 0].std() - 3.0) < 0.8
    assert s[:, 0].min() < -3.0
