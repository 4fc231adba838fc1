"""ChEES-HMC: adaptive-trajectory-length sampler (an extension;
Hoffman, Radul & Sountsov 2021)."""

import numpy as np
import jax.numpy as jnp
import pytest

import bayesfast_jax as bf


def test_chees_std_normal_moments():
    D = 6
    bf.utils.set_generator(11)
    den = bf.DensityLite(logp=lambda x: -0.5 * jnp.sum(x ** 2), input_size=D)
    tt = bf.sample(den, bf.CTrace(n_chain=16, n_iter=1200, n_warmup=500),
                   verbose=False)
    s = tt.get(flatten=True)
    assert np.abs(s.mean(0)).max() < 0.1
    assert np.all(np.abs(s.var(0) - 1) < 0.15)
    st = tt.sample_traces[0].stats.get()
    # the trajectory length must adapt away from its 1.0 init toward the
    # std-normal optimum (~pi/2 half-period)
    assert st['traj_len'][-1] > 1.3
    # all chains share one leapfrog count per iteration (lockstep)
    assert tt.n_call > 0


def test_chees_anisotropic_with_metric():
    """Scale mismatch handled by the adaptive diag metric."""
    D = 4
    scales = jnp.asarray([0.1, 1.0, 3.0, 10.0])
    bf.utils.set_generator(3)
    den = bf.DensityLite(
        logp=lambda x: -0.5 * jnp.sum((x / scales) ** 2), input_size=D)
    tt = bf.sample(den, bf.CTrace(n_chain=16, n_iter=1500, n_warmup=700),
                   verbose=False)
    s = tt.get(flatten=True)
    ratio = s.std(0) / np.asarray(scales)
    assert np.all(np.abs(ratio - 1) < 0.2)


def test_chees_continuation():
    D = 3
    bf.utils.set_generator(7)
    den = bf.DensityLite(logp=lambda x: -0.5 * jnp.sum(x ** 2), input_size=D)
    trace = bf.CTrace(n_chain=8, n_iter=200, n_warmup=100)
    tt = bf.sample(den, trace, n_run=120, verbose=False)
    assert tt.samples.shape == (8, 120, D)
    tt = bf.sample(den, tt, verbose=False)  # continue to n_iter
    assert tt.samples.shape == (8, 200, D)
    assert np.all(np.isfinite(tt.get()))
