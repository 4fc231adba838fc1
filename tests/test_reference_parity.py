"""Statistical parity certificate: our NUTS kernel vs the reference's.

The anchors (posterior moments, logz) prove end-to-end correctness, but
the claim of matching the reference's *exact* NUTS variant — multinomial
proposal, the extra inner-subtree U-turn checks, divergence threshold
(``/root/reference/bayesfast/samplers/nuts.py:88-167``) — deserves direct
evidence. This test runs the reference's own sampler
(imported straight from /root/reference; its pure-Python sampler modules
need no Cython) and our batched kernel on the same densities with the SAME
fixed step size and metric, then compares the per-transition tree-depth
and acceptance-statistic distributions.

Skipped when /root/reference is not present.
"""

import os
import sys
import types
import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy import stats as sps

import bayesfast_jax as bf
from bayesfast_jax.samplers.metrics import init_diag_metric
from bayesfast_jax.samplers.nuts import nuts_transition_batched

_REF = '/root/reference/bayesfast'

pytestmark = pytest.mark.skipif(not os.path.isdir(_REF),
                                reason='reference tree not available')


def _load_reference_nuts():
    """Import the reference's sampler stack as a synthetic package.

    The full reference package needs Cython extensions and the
    ``multiprocess`` dependency; the sampler modules themselves are pure
    Python, so we register stub parents (``refbf.core`` placeholders, a
    threading Lock for multiprocess) and import only what the samplers
    pull in.
    """
    import importlib

    if 'refbf.samplers.nuts' in sys.modules:
        return (sys.modules['refbf.samplers.nuts'],
                sys.modules['refbf.samplers.sample_trace'])

    if 'multiprocess' not in sys.modules:
        mp = types.ModuleType('multiprocess')
        mp.Lock = threading.Lock
        sys.modules['multiprocess'] = mp

    # the reference predates numpy 1.24 (uses the removed np.float alias)
    if not hasattr(np, 'float'):
        np.float = float

    root = types.ModuleType('refbf')
    root.__path__ = [_REF]
    sys.modules['refbf'] = root

    utils = types.ModuleType('refbf.utils')
    utils.__path__ = [os.path.join(_REF, 'utils')]
    sys.modules['refbf.utils'] = utils

    core = types.ModuleType('refbf.core')
    core.Density = type('Density', (), {})
    core.DensityLite = type('DensityLite', (), {})
    sys.modules['refbf.core'] = core

    samplers = types.ModuleType('refbf.samplers')
    samplers.__path__ = [os.path.join(_REF, 'samplers')]
    sys.modules['refbf.samplers'] = samplers

    hmc_utils = types.ModuleType('refbf.samplers.hmc_utils')
    hmc_utils.__path__ = [os.path.join(_REF, 'samplers', 'hmc_utils')]
    sys.modules['refbf.samplers.hmc_utils'] = hmc_utils

    st = importlib.import_module('refbf.samplers.sample_trace')
    nuts = importlib.import_module('refbf.samplers.nuts')
    return nuts, st


def _run_reference(nuts_mod, st_mod, logp_and_grad, D, eps, n_chain,
                   n_iter, seed, x0_scale=1.0):
    from refbf.samplers.hmc_utils.metrics import QuadMetricDiag
    from refbf.samplers.hmc_utils.step_size import DualAverageAdaptation
    depths, accepts = [], []
    rng = np.random.default_rng(seed)
    for c in range(n_chain):
        # n_warmup must be >= 1 in the reference; with both adapt flags off
        # the step size and metric stay fixed through it anyway. The step
        # size rides in as a pre-built DualAverageAdaptation: the trace's
        # scalar path rescales a raw value by input_size**-0.25
        # (``sample_trace.py:365-373``), which would desync the two runs.
        trace = st_mod.NTrace(
            n_chain=1, n_iter=n_iter, n_warmup=1,
            x_0=x0_scale * rng.normal(size=(1, D)),
            random_generator=np.random.default_rng(seed + 1000 + c),
            step_size=DualAverageAdaptation(eps, 0.8, 0.05, 0.75, 10.,
                                            False),
            adapt_step_size=False,
            metric=QuadMetricDiag(np.ones(D)), adapt_metric=False)
        trace._init_chain(0)
        sampler = nuts_mod.NUTS(logp_and_grad=logp_and_grad,
                                sample_trace=trace)
        sampler.run(n_run=n_iter, verbose=False)
        s = trace.stats.get(include_warmup=True)
        depths.append(np.asarray(s['tree_depth']))
        accepts.append(np.asarray(s['mean_tree_accept']))
    return np.concatenate(depths), np.concatenate(accepts)


def _run_ours(lpg_b, D, eps, n_chain, n_iter, seed, x0_scale=1.0):
    metric = init_diag_metric(jnp.zeros(D), jnp.ones(D))
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    q = x0_scale * jax.random.normal(k0, (n_chain, D), jnp.float64)

    @jax.jit
    def run(key, q):
        def body(carry, _):
            key, q = carry
            key, sub = jax.random.split(key)
            q, st = nuts_transition_batched(
                sub, q, metric, jnp.float64(eps), lpg_b, 10, 1000.)
            return (key, q), (st.tree_depth, st.mean_tree_accept)
        (_, q), (dep, acc) = jax.lax.scan(body, (key, q), None,
                                          length=n_iter)
        return dep, acc

    dep, acc = run(key, q)
    return np.asarray(dep).ravel(), np.asarray(acc).ravel()


def _compare(d_ref, a_ref, d_our, a_our):
    # acceptance statistic: two-sample KS (continuous)
    ks = sps.ks_2samp(a_ref, a_our)
    assert ks.pvalue > 0.01, (
        f'acceptance distributions differ: KS p={ks.pvalue:.4g}, '
        f'means {a_ref.mean():.4f} vs {a_our.mean():.4f}')
    # tree depth: discrete — chi-square homogeneity on the depth histogram
    lo = int(min(d_ref.min(), d_our.min()))
    hi = int(max(d_ref.max(), d_our.max()))
    bins = np.arange(lo, hi + 2)
    h_ref = np.histogram(d_ref, bins)[0]
    h_our = np.histogram(d_our, bins)[0]
    keep = (h_ref + h_our) >= 10
    table = np.stack([h_ref[keep], h_our[keep]])
    chi2 = sps.chi2_contingency(table)
    assert chi2.pvalue > 0.01, (
        f'tree-depth distributions differ: chi2 p={chi2.pvalue:.4g}, '
        f'means {d_ref.mean():.3f} vs {d_our.mean():.3f}')


def test_nuts_parity_std_normal():
    nuts_mod, st_mod = _load_reference_nuts()
    D, eps, n_chain, n_iter = 8, 0.45, 8, 400

    def lpg_np(x):
        return -0.5 * np.sum(x ** 2), -x

    logp = lambda x: -0.5 * jnp.sum(x ** 2)
    lpg_b = jax.vmap(jax.value_and_grad(logp))

    d_ref, a_ref = _run_reference(nuts_mod, st_mod, lpg_np, D, eps,
                                  n_chain, n_iter, seed=10)
    d_our, a_our = _run_ours(lpg_b, D, eps, n_chain, n_iter, seed=11)
    _compare(d_ref, a_ref, d_our, a_our)


def test_nuts_parity_ill_conditioned_gaussian():
    nuts_mod, st_mod = _load_reference_nuts()
    D, eps, n_chain, n_iter = 6, 0.12, 8, 400
    scales = np.geomspace(0.3, 3.0, D)
    prec = 1.0 / scales ** 2

    def lpg_np(x):
        return -0.5 * np.sum(prec * x ** 2), -prec * x

    pj = jnp.asarray(prec)
    logp = lambda x: -0.5 * jnp.sum(pj * x ** 2)
    lpg_b = jax.vmap(jax.value_and_grad(logp))

    d_ref, a_ref = _run_reference(nuts_mod, st_mod, lpg_np, D, eps,
                                  n_chain, n_iter, seed=20)
    d_our, a_our = _run_ours(lpg_b, D, eps, n_chain, n_iter, seed=21)
    _compare(d_ref, a_ref, d_our, a_our)


def test_nuts_parity_hard_bounded_density():
    """Parity on a HARD-BOUNDED density sampled in transformed space: our
    side runs the production fused transform (``to_original_with_logdet``
    + rational custom JVP) through ``DensityLite.device_logp_and_grad``;
    the reference side evaluates the mathematically identical transformed
    density with NumPy (the ``_constraint.pyx:19-226`` formulas). This is
    exactly the subtle-parity surface of the fused-transform rewrite."""
    nuts_mod, st_mod = _load_reference_nuts()
    D, eps, n_chain, n_iter = 6, 0.2, 8, 400

    lower = np.array([-3., -2., -np.inf, -4., -2.5, -np.inf])
    upper = np.array([3., np.inf, 2., 4., 2.5, np.inf])
    scales = np.stack([np.where(np.isfinite(lower), lower, 0.0),
                       np.where(np.isfinite(upper), upper, 1.0)], axis=1)
    bounds = np.stack([np.isfinite(lower), np.isfinite(upper)], axis=1)
    c = np.array([0.5, -0.3, 0.2, 0.0, 0.4, -0.1])
    s = np.array([1.0, 0.8, 0.9, 1.5, 0.7, 1.2])

    # ---- reference side: transformed-space logp/grad in NumPy ----
    from bayesfast_jax.ops import constraint as con

    has_lo, has_hi = bounds[:, 0], bounds[:, 1]
    m_lohi = has_lo & has_hi
    m_one = has_lo ^ has_hi

    def lpg_np(x_t):
        x_o = con.np_to_original(x_t, scales, bounds)
        g = con.np_to_original_grad(x_t, scales, bounds)
        logp = (-0.5 * np.sum(((x_o - c) / s) ** 2)
                + np.sum(np.log(np.abs(g))))
        g_o = -(x_o - c) / s ** 2
        sig = 1.0 / (1.0 + np.exp(-x_t))
        # dlog|g|/dx: (1-2*sigmoid) on two-sided dims, 1 on one-sided
        h = np.where(m_lohi, 1.0 - 2.0 * sig, np.where(m_one, 1.0, 0.0))
        return logp, g_o * g + h

    # ---- our side: the production density object ----
    import bayesfast_jax as bf2
    den = bf2.DensityLite(
        logp=lambda x: -0.5 * jnp.sum(((x - jnp.asarray(c))
                                       / jnp.asarray(s)) ** 2),
        input_size=D, input_scales=scales, hard_bounds=bounds,
        vectorized=True)
    lpg = den.device_logp_and_grad(original_space=False)
    lpg_b = jax.vmap(lambda x: lpg((), x))

    # spot-check value/grad agreement before the statistical run
    xt = np.random.default_rng(0).normal(size=(3, D))
    for row in xt:
        lp_r, g_r = lpg_np(row)
        lp_o, g_o = lpg((), jnp.asarray(row))
        np.testing.assert_allclose(float(lp_o), lp_r, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(g_o), g_r, rtol=1e-9)

    # gentle starts + moderate step: a unit-normal start in transformed
    # space can land on exp-branch curvature where ANY fixed step
    # diverges forever (both samplers show the same stuck-chain
    # pathology, but the stuck-chain count is seed-noise that swamps the
    # distribution comparison)
    d_ref, a_ref = _run_reference(nuts_mod, st_mod, lpg_np, D, eps,
                                  n_chain, n_iter, seed=30, x0_scale=0.2)
    d_our, a_our = _run_ours(lpg_b, D, eps, n_chain, n_iter, seed=31,
                             x0_scale=0.2)
    _compare(d_ref, a_ref, d_our, a_our)


def test_adaptive_warmup_parity():
    """Adaptive-warmup parity: both samplers run their FULL warmup
    machinery (dual averaging toward target 0.8, windowed diag-Welford
    metric) on the same ill-conditioned Gaussian; the adapted per-chain
    step sizes and mass-matrix entries must be statistically
    indistinguishable."""
    nuts_mod, st_mod = _load_reference_nuts()
    from refbf.samplers.hmc_utils.metrics import QuadMetricDiagAdapt
    D, n_chain, n_warmup = 6, 16, 600
    scales_d = np.geomspace(0.5, 2.0, D)
    prec = 1.0 / scales_d ** 2

    def lpg_np(x):
        return -0.5 * np.sum(prec * x ** 2), -prec * x

    # ---- reference: one adaptive chain at a time ----
    ref_steps, ref_vars = [], []
    rng = np.random.default_rng(77)
    for ci in range(n_chain):
        trace = st_mod.NTrace(
            n_chain=1, n_iter=n_warmup + 1, n_warmup=n_warmup,
            x_0=rng.normal(size=(1, D)),
            random_generator=np.random.default_rng(5000 + ci),
            step_size=1.0, adapt_step_size=True,
            metric=QuadMetricDiagAdapt(D, np.zeros(D), np.ones(D)),
            adapt_metric=True)
        trace._init_chain(0)
        sampler = nuts_mod.NUTS(logp_and_grad=lpg_np, sample_trace=trace)
        sampler.run(n_run=n_warmup + 1, verbose=False)
        ref_steps.append(trace.step_size.current(False))
        ref_vars.append(np.asarray(trace.metric._var))
    ref_steps = np.asarray(ref_steps)
    ref_vars = np.asarray(ref_vars)

    # ---- ours: the batched driver via the public entry point ----
    import bayesfast_jax as bf2
    pj = jnp.asarray(prec)
    den = bf2.DensityLite(logp=lambda x: -0.5 * jnp.sum(pj * x ** 2),
                          input_size=D, vectorized=True)
    bf2.utils.set_generator(123)
    tt = bf2.sample(den, {'n_chain': n_chain, 'n_iter': n_warmup + 1,
                          'n_warmup': n_warmup,
                          'x_0': rng.normal(size=(n_chain, D))},
                    verbose=False)
    carry = tt.trace._carry
    our_steps = np.asarray(jnp.exp(carry.step.log_bar))
    our_vars = np.asarray(carry.metric.var)

    # adapted step sizes: same distribution across chains
    ks = sps.ks_2samp(ref_steps, our_steps)
    assert ks.pvalue > 0.01, (
        f'adapted step sizes differ: KS p={ks.pvalue:.4g}, '
        f'means {ref_steps.mean():.4f} vs {our_steps.mean():.4f}')
    # adapted metric: per-dim pooled variance within 15% of each other
    # (both estimate the true scales_d^2 from ~600 warmup draws)
    r = np.log(our_vars.mean(axis=0) / ref_vars.mean(axis=0))
    assert np.all(np.abs(r) < 0.15), (
        f'adapted metric differs: log-ratios {r}')
