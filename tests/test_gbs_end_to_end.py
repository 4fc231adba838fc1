"""End-to-end: NUTS sampling -> GBS evidence on a TraceTuple
(the reference's banana/funnel/ring/cauchy-gbs notebook pattern)."""

import numpy as np
import jax.numpy as jnp

import bayesfast_jax as bf
from bayesfast_jax.evidence import GBS


def test_nuts_then_gbs_logz():
    bf.utils.set_generator(21)
    dim = 6
    rng = np.random.default_rng(8)
    A = rng.normal(size=(dim, dim))
    cov = A @ A.T / dim + np.eye(dim)
    prec = np.linalg.inv(cov)
    logz_true = 0.5 * np.linalg.slogdet(2 * np.pi * cov)[1]

    den = bf.DensityLite(
        logp=lambda x: -0.5 * x @ jnp.asarray(prec) @ x, input_size=dim)
    tt = bf.sample(den, {'n_chain': 8, 'n_iter': 1500, 'n_warmup': 500},
                   verbose=False)

    gbs = GBS(sit={'n_iter': 8, 'random_generator': 3}, n_q=2000)
    logz, logz_err = gbs.run(
        x_p=tt, logp=lambda x: den.logp(x, original_space=True),
        logp_p=tt.get(return_type='logp', flatten=False))
    assert logz_err < 0.2
    assert abs(logz - logz_true) < max(5 * logz_err, 0.1)


def test_recipe_with_gbs_evidence():
    bf.utils.set_generator(33)
    dim = 3
    den = bf.DensityLite(
        logp=lambda x: -0.5 * jnp.sum(x ** 2) - 0.1 * jnp.sum(x ** 4),
        input_size=dim)
    rec = bf.Recipe(
        density=den,
        sample={'sample_trace': {'n_chain': 8, 'n_iter': 1500,
                                 'n_warmup': 500}},
        post={'evidence_method': {'sit': {'n_iter': 6,
                                          'random_generator': 5},
                                  'n_q': 2000}},
    )
    rec.run()
    res = rec.get()
    assert res.logz is not None and res.logz_err is not None
    # quartic-perturbed gaussian: logz from 1-d quadrature
    from scipy.integrate import quad
    z1 = quad(lambda t: np.exp(-0.5 * t * t - 0.1 * t ** 4), -10, 10)[0]
    logz_true = dim * np.log(z1)
    assert abs(res.logz - logz_true) < max(5 * res.logz_err, 0.1)
