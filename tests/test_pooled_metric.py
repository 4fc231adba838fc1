"""Pooled cross-chain metric adaptation (an extension).

With C chains feeding one shared Welford accumulator, the mass matrix sees
C samples per iteration — adaptation converges in ~1/C of the warmup
iterations. The per-chain path stays the reference-parity default.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import bayesfast_jax as bf
from bayesfast_jax.samplers.metrics import (init_diag_metric,
                                            init_full_metric, update_metric,
                                            update_metric_pooled)


def test_batch_welford_equals_sequential():
    rng = np.random.default_rng(0)
    xb = jnp.asarray(rng.normal(size=(16, 3)))
    m_seq = init_diag_metric(jnp.zeros(3), jnp.ones(3))
    for i in range(16):
        # per-sample updates with the window far away
        m_seq = update_metric(m_seq, xb[i], True, update_window=1000)
    m_pool = init_diag_metric(jnp.zeros(3), jnp.ones(3))
    m_pool = update_metric_pooled(m_pool, xb, True, update_window=1000)
    assert np.allclose(np.asarray(m_seq.fg.mean), np.asarray(m_pool.fg.mean))
    assert np.allclose(np.asarray(m_seq.fg.raw), np.asarray(m_pool.fg.raw),
                       rtol=1e-10)


def test_pooled_diag_sampling():
    bf.utils.set_generator(4)
    rng = np.random.default_rng(3)
    scales = jnp.asarray(10.0 ** rng.uniform(-1, 1, 6))

    den = bf.DensityLite(logp=lambda x: -0.5 * jnp.sum((x / scales) ** 2),
                         input_size=6)
    # short warmup: pooled adaptation should still find the scales
    tt = bf.sample(den, {'n_chain': 32, 'n_iter': 700, 'n_warmup': 300,
                         'pooled_metric': True}, verbose=False)
    s = tt.get(flatten=True)
    assert np.allclose(s.std(axis=0), np.asarray(scales), rtol=0.15)
    # the shared metric matched the target variances
    var = np.asarray(tt.trace._carry.metric.var)
    assert var.shape == (6,)
    assert np.allclose(np.sqrt(var), np.asarray(scales), rtol=0.25)


def test_pooled_metric_sharded_mesh():
    # pooled adaptation across a sharded chain axis: the batch Welford
    # merge becomes an XLA collective (psum) over the 8-device mesh
    from bayesfast_jax.parallel import make_mesh, set_mesh
    set_mesh(make_mesh())
    try:
        bf.utils.set_generator(6)
        scales = jnp.asarray([0.3, 3.0, 1.0, 0.1])
        den = bf.DensityLite(
            logp=lambda x: -0.5 * jnp.sum((x / scales) ** 2), input_size=4)
        tt = bf.sample(den, {'n_chain': 32, 'n_iter': 600, 'n_warmup': 250,
                             'pooled_metric': True}, verbose=False)
        s = tt.get(flatten=True)
        assert np.allclose(s.std(axis=0), np.asarray(scales), rtol=0.2)
    finally:
        set_mesh(None)


def test_pooled_full_metric_sampling():
    bf.utils.set_generator(5)
    cov = np.array([[2.0, 1.2], [1.2, 1.0]])
    prec = jnp.asarray(np.linalg.inv(cov))
    den = bf.DensityLite(logp=lambda x: -0.5 * x @ prec @ x, input_size=2)
    tt = bf.sample(den, {'n_chain': 32, 'n_iter': 700, 'n_warmup': 300,
                         'metric': 'full', 'pooled_metric': True},
                   verbose=False)
    s = tt.get(flatten=True)
    assert np.allclose(np.cov(s, rowvar=False), cov, atol=0.2)
    assert np.allclose(np.asarray(tt.trace._carry.metric.cov), cov, atol=0.4)
