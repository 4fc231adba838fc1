"""Tempered (TNUTS/THMC) sampler tests: continuous tempering between a
broad base density and the target, with importance-weighted estimates."""

import numpy as np
import jax.numpy as jnp
import pytest

import bayesfast_jax as bf


def _densities(dim=4):
    target_var = 0.5
    base_var = 4.0
    target = bf.DensityLite(
        logp=lambda x: -0.5 * jnp.sum(x ** 2) / target_var, input_size=dim)
    base = bf.DensityLite(
        logp=lambda x: -0.5 * jnp.sum(x ** 2) / base_var, input_size=dim)
    return target, base, target_var


def test_tnuts_weighted_moments():
    bf.utils.set_generator(17)
    target, base, target_var = _densities()
    tt = bf.sample(target,
                   {'density_base': base, 'n_chain': 8, 'n_iter': 3000,
                    'n_warmup': 1000},
                   sampler='TNUTS', verbose=False)
    assert tt.sampler == 'TNUTS'
    s = tt.get(flatten=True, original_space=False)
    w = tt.get(return_type='weights', flatten=True)
    u = tt.get(return_type='u', flatten=True)
    assert s.shape[0] == w.shape[0] == u.shape[0]
    assert np.all(w > 0)
    # the temperature coordinate explores both phases (its marginal is
    # tilted by the free-energy difference between target and base, so the
    # high-beta tail can be small)
    assert (u > 0).mean() > 0.02 and (u < 0).mean() > 0.02
    # importance-weighted moments target the beta=1 (target) density
    mean_w = np.sum(s * w[:, None], axis=0) / np.sum(w)
    var_w = np.sum(s ** 2 * w[:, None], axis=0) / np.sum(w)
    assert np.all(np.abs(mean_w) < 0.15)
    assert np.allclose(var_w, target_var, atol=0.15)


def test_thmc_smoke():
    bf.utils.set_generator(23)
    target, base, target_var = _densities(3)
    tt = bf.sample(target,
                   {'density_base': base, 'n_chain': 4, 'n_iter': 1500,
                    'n_warmup': 600, 'n_int_step': 16},
                   sampler='THMC', verbose=False)
    assert tt.sampler == 'THMC'
    w = tt.get(return_type='weights', flatten=True)
    s = tt.get(flatten=True, original_space=False)
    var_w = np.sum(s ** 2 * w[:, None], axis=0) / np.sum(w)
    assert np.allclose(var_w, target_var, atol=0.25)
    st = tt[0].stats.get()
    assert 'u' in st and 'weight' in st and 'accept_stat' in st
