"""Affine-invariant ensemble sampler tests (working implementation of the
reference's planned-but-stubbed sampler)."""

import numpy as np
import jax.numpy as jnp

import bayesfast_jax as bf


def test_ensemble_gaussian_moments():
    bf.utils.set_generator(12)
    cov = np.array([[2.0, 0.8], [0.8, 1.0]])
    prec = jnp.asarray(np.linalg.inv(cov))
    den = bf.DensityLite(logp=lambda x: -0.5 * x @ prec @ x, input_size=2)
    tt = bf.sample(den, {'n_chain': 64, 'n_iter': 2000, 'n_warmup': 500},
                   sampler='Ensemble', verbose=False)
    assert tt.sampler == 'Ensemble'
    s = tt.get(flatten=True)
    assert s.shape == (64 * 1500, 2)
    assert np.allclose(s.mean(axis=0), 0.0, atol=0.1)
    assert np.allclose(np.cov(s, rowvar=False), cov, atol=0.25)
    st = tt[0].stats.get()
    assert 0.1 < np.mean(st['accepted']) < 0.9
    assert tt.n_call == 64 * 2001


def test_ensemble_bounded_continuation():
    bf.utils.set_generator(13)

    def logp(x):
        return jnp.sum(1.5 * jnp.log(x) + 1.5 * jnp.log1p(-x))  # Beta(2.5,2.5)

    den = bf.DensityLite(logp=logp, input_size=2,
                         input_scales=np.array([[0., 1.], [0., 1.]]),
                         hard_bounds=True)
    tt = bf.sample(den, {'n_chain': 32, 'n_iter': 1000, 'n_warmup': 300},
                   sampler='Ensemble', verbose=False)
    tt.trace.add_iter(500)
    tt = bf.sample(den, tt, verbose=False)
    assert tt.i_iter == 1500
    s = tt.get(flatten=True)
    assert (s > 0).all() and (s < 1).all()
    assert np.allclose(s.mean(axis=0), 0.5, atol=0.03)
