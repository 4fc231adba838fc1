"""SIT flow and Gaussianized evidence tests.

The reference covers these only via notebooks; here we add seeded checks:
spline round trips, ICA decorrelation, SIT density recovery, and
logz-within-error on an unnormalized Gaussian with known evidence.
"""

import numpy as np
import pytest

import bayesfast_jax as bf
from bayesfast_jax.utils.cubic import cubic_spline, CubicSplineSet
from bayesfast_jax.utils.kde import kde
from bayesfast_jax.ops.ica import fast_ica
from bayesfast_jax.transforms import SIT
from bayesfast_jax.evidence import GBS, GIS, GHM, bridge, importance

import jax


def test_cubic_spline_roundtrip():
    rng = np.random.default_rng(0)
    x_all = rng.normal(size=5000) * 2.0
    f = lambda x: np.arctan(x) * 2 + 0.1 * x  # smooth monotone
    sp = cubic_spline(x_all, f)
    xt = np.linspace(-3, 3, 101)
    assert np.allclose(sp(xt), f(xt), atol=1e-4)
    # derivative vs finite difference
    d = sp.derivative(xt)
    d_fd = (sp(xt + 1e-5) - sp(xt - 1e-5)) / 2e-5
    assert np.allclose(d, d_fd, rtol=1e-4, atol=1e-6)
    # inverse
    yt = sp(xt)
    assert np.allclose(sp.solve(yt), xt, atol=1e-6)
    # linear extrapolation outside data range stays finite and monotone
    far = np.array([-50.0, 50.0])
    vals = sp(far)
    assert np.all(np.isfinite(vals)) and vals[0] < vals[1]


def test_cubic_spline_set_batch():
    rng = np.random.default_rng(1)
    sps = []
    funcs = [lambda x: x ** 3 / 10 + x, lambda x: np.tanh(x) * 3 + 0.2 * x]
    for f in funcs:
        sps.append(cubic_spline(rng.normal(size=3000) * 1.5, f))
    ss = CubicSplineSet(sps)
    xt = np.linspace(-2, 2, 50)
    out = np.asarray(ss.evaluate(np.stack([xt, xt])))
    for d, f in enumerate(funcs):
        assert np.allclose(out[d], f(xt), atol=1e-3)
    back = np.asarray(ss.solve(out))
    assert np.allclose(back, np.stack([xt, xt]), atol=1e-5)


def test_kde_cdf():
    rng = np.random.default_rng(2)
    x = rng.normal(size=20000)
    k = kde(x)
    from scipy.stats import norm
    pts = np.array([-1.0, 0.0, 1.0])
    assert np.allclose(k.cdf(pts), norm.cdf(pts), atol=0.02)
    # weighted version
    w = np.ones_like(x)
    k2 = kde(x, weights=w)
    assert np.allclose(k2.cdf(pts), k.cdf(pts))


def test_fast_ica_unmixing():
    rng = np.random.default_rng(3)
    s = np.stack([rng.laplace(size=20000), rng.uniform(-1, 1, 20000)],
                 axis=-1)
    mix = np.array([[1.0, 0.5], [-0.3, 1.2]])
    x = s @ mix.T
    comps, mean = fast_ica(x, jax.random.PRNGKey(0))
    y = (x - np.asarray(mean)) @ np.asarray(comps).T
    # unmixed signals decorrelated with unit variance
    c = np.cov(y, rowvar=False)
    assert np.allclose(c, np.eye(2), atol=0.05)
    # each recovered component matches one source up to sign/scale
    corr = np.corrcoef(np.concatenate([y, s], axis=-1), rowvar=False)[:2, 2:]
    assert np.allclose(np.sort(np.abs(corr).max(axis=1)), [1, 1], atol=0.05)


def _corr_gauss_samples(n, seed=4):
    rng = np.random.default_rng(seed)
    cov = np.array([[2.0, 0.6, 0.2, 0.0], [0.6, 1.0, 0.3, 0.1],
                    [0.2, 0.3, 1.5, 0.2], [0.0, 0.1, 0.2, 0.8]])
    x = rng.multivariate_normal(np.zeros(4), cov, n)
    prec = np.linalg.inv(cov)
    logp = lambda v: -0.5 * np.einsum('...i,ij,...j->...', v, prec, v)
    # evidence of the unnormalized density
    logz = 0.5 * np.linalg.slogdet(2 * np.pi * cov)[1]
    return x, logp, logz, cov


def test_sit_density_recovery():
    x, logp, logz, cov = _corr_gauss_samples(8000)
    sit = SIT(n_iter=6, random_generator=0)
    sit.fit(x)
    # logq should approximate the normalized density in the bulk
    from scipy.stats import multivariate_normal
    pts = x[:200]
    lq = sit.logq(pts)
    lp_true = multivariate_normal.logpdf(pts, np.zeros(4), cov)
    assert np.mean(np.abs(lq - lp_true)) < 0.2
    # samples from the flow match the moments
    xs, _, _ = sit.sample(4000)
    assert np.allclose(np.cov(xs, rowvar=False), cov, atol=0.25)
    # round-trip consistency
    y, lj_f = sit.forward_transform(pts)
    x_back, lj_b = sit.backward_transform(y)
    assert np.allclose(x_back, pts, atol=1e-4)
    # both directions report log|dy/dx| (the reference's convention,
    # ``sit.py:385-455``), so the values agree rather than negate
    assert np.allclose(lj_f, lj_b, atol=1e-4)


def test_gbs_evidence_gaussian():
    x, logp, logz_true, _ = _corr_gauss_samples(8000)
    x_chains = x.reshape(8, 1000, 4)
    gbs = GBS(sit={'n_iter': 6, 'random_generator': 0}, n_q=2000)
    logz, logz_err = gbs.run(x_p=x_chains, logp=logp)
    assert logz_err < 0.25
    assert abs(logz - logz_true) < max(5 * logz_err, 0.1)


def test_gis_ghm_evidence_gaussian():
    x, logp, logz_true, _ = _corr_gauss_samples(8000, seed=5)
    x_chains = x.reshape(8, 1000, 4)
    gis = GIS(sit={'n_iter': 6, 'random_generator': 1}, n_q=4000)
    logz, logz_err = gis.run(x_p=x_chains, logp=logp)
    assert abs(logz - logz_true) < max(5 * logz_err, 0.15)

    ghm = GHM(sit={'n_iter': 6, 'random_generator': 2})
    logz2, logz_err2 = ghm.run(x_p=x_chains, logp=logp)
    assert abs(logz2 - logz_true) < max(5 * logz_err2, 0.3)


def test_bridge_analytic():
    # p = q = same set of iid normals -> logr = 0
    rng = np.random.default_rng(7)
    z = rng.normal(size=4000)
    lp = -0.5 * z ** 2
    lq = -0.5 * z ** 2
    z2 = rng.normal(size=4000)
    lp2 = -0.5 * z2 ** 2
    lq2 = -0.5 * z2 ** 2
    logr, err = bridge(lp, lp2, lq, lq2)
    assert abs(logr) < 3 * max(err, 1e-3) + 1e-6


def test_triangle_plot_fallback():
    """triangle_plot must render without getdist (matplotlib corner
    fallback) and hook into fit(plot=-1)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from bayesfast_jax.transforms import SIT

    rng = np.random.default_rng(0)
    data = rng.normal(size=(500, 3)) * [1.0, 2.0, 0.5]
    sit = SIT(n_iter=1, random_generator=0, m_plot=3)
    sit.fit(data=data)
    fig = sit.triangle_plot(show=False)
    assert len(fig.axes) >= 6  # 3x3 grid, upper triangle hidden
    plt.close(fig)


def test_device_kde_fit_matches_host():
    """The float32 device KDE-cdf fit path (used automatically on
    accelerator-backed hosts) must reproduce the float64 host fits."""
    from bayesfast_jax import config as bfc
    from bayesfast_jax.transforms import SIT

    rng = np.random.default_rng(0)
    n = 40000  # above the batched-device-fit threshold (n * dim >= 1e5)
    data = np.stack([rng.normal(size=n) ** 3, rng.gamma(2, size=n),
                     rng.standard_t(3, size=n)], axis=1)
    outs = {}
    try:
        for mode in (False, True):
            bfc.set_kde_device(mode)
            sit = SIT(n_iter=3, random_generator=3)
            sit.fit(data=data)
            outs[mode] = sit.logq(data[:2000])
    finally:
        bfc.set_kde_device(None)
    d = outs[True] - outs[False]
    assert np.abs(d).mean() < 0.01
    assert abs(d.mean()) < 1e-3
