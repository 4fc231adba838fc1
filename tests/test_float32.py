"""float32 statistical test tier.

Everything else in the suite runs float64; these tests flip x64 off so the
whole sampling path — starts, descent, step probe, adaptation, NUTS — runs
in the chip-native dtype, and assert *statistical* correctness (moments and
log-evidence within tolerances). float32 sampling is exact (the
Metropolis/multinomial corrections use the same float32 energies the
trajectories produce); on very stiff targets it is merely less efficient
(smaller adapted steps). The robustness stack validated here is what makes
cold starts work without float64: backtracking start descent
(``core.sample._descend_x0``), per-chain reasonable-step probe
(``_find_reasonable_step``), Stan-style metric shrinkage
(``samplers.metrics``), and Kahan-compensated leapfrog accumulators
(``samplers.nuts.leapfrog_t``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import bayesfast_jax as bf


@pytest.fixture(autouse=True)
def _f32_mode():
    jax.config.update('jax_enable_x64', False)
    bf.utils.set_generator(5)
    yield
    jax.config.update('jax_enable_x64', True)


def test_f32_gaussian_moments():
    dim = 6
    rng = np.random.default_rng(2)
    A = rng.normal(size=(dim, dim))
    cov = A @ A.T / dim + np.eye(dim)
    prec = jnp.asarray(np.linalg.inv(cov), jnp.float32)

    den = bf.DensityLite(logp=lambda x: -0.5 * x @ prec @ x, input_size=dim)
    tt = bf.sample(den, {'n_chain': 8, 'n_iter': 1500, 'n_warmup': 500},
                   verbose=False)
    s = tt.get(flatten=True)
    assert s.dtype == np.float32
    se = np.sqrt(np.diag(cov) / 500)
    assert np.all(np.abs(s.mean(axis=0)) < 5 * se)
    assert np.abs(np.cov(s, rowvar=False) - cov).max() < 0.3
    st = tt[0].stats.get()
    assert np.sum(st['diverging']) == 0


def test_f32_bounded_cold_start():
    """Stiff bounded density from raw Sobol cold starts: the descent +
    probe stack must land the chains and adapt without step collapse."""
    D, Q = 8, 0.1
    bound = np.tile(np.array([[-10., 10.]]), (D, 1))
    const = float(D * np.log(20.))

    def logp(x):
        return (-jnp.sum((x[::2] ** 2 - x[1::2]) ** 2 / Q
                         + (x[::2] - 1) ** 2) - const)

    den = bf.DensityLite(logp=logp, input_size=D, input_scales=bound,
                         hard_bounds=True)
    tt = bf.sample(den, {'n_chain': 16, 'n_iter': 2000, 'n_warmup': 800},
                   verbose=False)
    lp = tt.get(flatten=True, return_type='logp')
    # analytic typical level: E[logp] = -D/2 - const
    assert abs(lp.mean() - (-D / 2 - const)) < 2.0
    # no stranded chains
    lp_chain = tt.get(flatten=False, return_type='logp').mean(axis=1)
    assert lp_chain.max() - lp_chain.min() < 8.0
    # steps did not collapse
    ss = tt.trace._stats_arrays['step_size_bar'][:, -1]
    assert ss.min() > 1e-4


def test_f32_gbs_logz():
    """GBS log-evidence from float32 chains on a 4-d unnormalized normal
    (true logz = 0.5 * D * log 2pi)."""
    dim = 4
    den = bf.DensityLite(logp=lambda x: -0.5 * jnp.sum(x * x),
                         input_size=dim)
    tt = bf.sample(den, {'n_chain': 8, 'n_iter': 1200, 'n_warmup': 400},
                   verbose=False)
    logz, err = bf.GBS(n_q=4000)(tt, den.logp)
    true = 0.5 * dim * np.log(2 * np.pi)
    assert abs(logz - true) < max(4 * err, 0.05)


def test_descent_and_probe_bookkeeping():
    """The start descent and step probe must improve logp, produce sane
    per-chain steps, and account their evaluations in n_call."""
    D = 16

    def logp(x):
        return -0.5 * jnp.sum(x * x) * 100.0  # narrow: cold starts are far

    den = bf.DensityLite(logp=logp, input_size=D)
    tt = bf.sample(den, {'n_chain': 8, 'n_iter': 60, 'n_warmup': 30},
                   verbose=False)
    assert tt.trace._descent_calls > 0
    # n_call = leapfrogs + per-iteration states + init + descent/probe
    ts = tt.trace._stats_arrays['tree_size']
    expect = int(np.sum(ts[:, 1:]) + 8 * (60 + 1)) + tt.trace._descent_calls
    assert tt.n_call == expect
