"""Mesh-sharded evidence phase: the sharded paths must reproduce the
single-device results exactly (same seeds, same reductions up to float
associativity).

The reference farms GBS logp evaluation and SIT per-dim fits over a process
pool (``bayesfast/evidence/gaussianized.py:171-176``,
``bayesfast/transforms/sit.py:230``); here the proposal batches, flow
evaluations and KDE-cdf data sums shard over the same device mesh the
sampler uses.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import bayesfast_jax as bf
from bayesfast_jax.parallel.mesh import (make_mesh, make_mesh_2d, set_mesh,
                                         shard_batch, mesh_size)
from bayesfast_jax.ops.kde import kde_cdf_batch


@pytest.fixture
def mesh8():
    mesh = make_mesh(jax.devices()[:8])
    yield mesh
    set_mesh(None)


def test_kde_cdf_batch_sharded_matches(mesh8):
    rng = np.random.default_rng(0)
    D, N, M = 3, 1000, 17
    data = jnp.asarray(rng.normal(size=(D, N)))
    w = jnp.asarray(rng.uniform(0.5, 1.5, N) / N)
    h = jnp.asarray([0.3, 0.2, 0.5])
    x = jnp.asarray(rng.normal(size=(D, M)))
    ref = np.asarray(kde_cdf_batch(x, data, w, h))
    set_mesh(mesh8)
    out = np.asarray(kde_cdf_batch(x, data, w, h))
    assert np.allclose(out, ref, atol=1e-12)


def test_shard_batch_roundtrip(mesh8):
    set_mesh(mesh8)
    x = jnp.arange(64.0).reshape(16, 4)
    xs = shard_batch(x)
    assert np.allclose(np.asarray(xs), np.asarray(x))
    # non-divisible axis: silently unsharded, values unchanged
    y = jnp.arange(36.0).reshape(9, 4)
    ys = shard_batch(y)
    assert np.allclose(np.asarray(ys), np.asarray(y))


def _gbs_value(den, mesh):
    set_mesh(mesh)
    bf.utils.set_generator(7)
    tt = bf.sample(den, {'n_chain': 8, 'n_iter': 300, 'n_warmup': 150},
                   verbose=False)
    gbs = bf.GBS(n_q=256, sit={'n_iter': 2, 'random_generator': 3})
    lz, lz_err = gbs(tt, den.logp)[:2]
    set_mesh(None)
    return lz, lz_err


def test_gbs_mesh_matches_single_device(mesh8):
    D = 3
    den = bf.DensityLite(logp=lambda x: -0.5 * jnp.sum(x ** 2),
                         input_size=D, vectorized=True)
    lz_s, _ = _gbs_value(den, None)
    lz_m, _ = _gbs_value(den, mesh8)
    assert np.isfinite(lz_m)
    assert abs(lz_m - lz_s) < 1e-6
    # and it lands on the truth for the unnormalized Gaussian
    assert abs(lz_m - 0.5 * D * np.log(2 * np.pi)) < 0.2


def test_two_axis_mesh_sampler_equivalence():
    mesh2 = make_mesh_2d(shape=(2, 4), devices=jax.devices()[:8])
    assert mesh_size(mesh2) == 8
    D = 4
    den = bf.DensityLite(logp=lambda x: -0.5 * jnp.sum(x ** 2),
                         input_size=D, vectorized=True)
    try:
        bf.utils.set_generator(11)
        tt_m = bf.sample(den, {'n_chain': 16, 'n_iter': 5, 'n_warmup': 3},
                         verbose=False, mesh=mesh2)
        bf.utils.set_generator(11)
        tt_s = bf.sample(den, {'n_chain': 16, 'n_iter': 5, 'n_warmup': 3},
                         verbose=False, mesh=None)
        assert np.allclose(tt_m.samples, tt_s.samples, atol=1e-12)
    finally:
        set_mesh(None)


def test_mesh_sampler_matches_single(mesh8):
    """A chain-sharded run through warmup (dual averaging + Welford) and
    past it matches the unsharded run on the same seed: the tree kernel's
    random draws are defined independently of how the chain axis is laid
    out, so only float reassociation could separate the two."""
    D = 3
    den = bf.DensityLite(logp=lambda x: -0.5 * jnp.sum(x ** 2),
                         input_size=D, vectorized=True)
    cfg = {'n_chain': 16, 'n_iter': 60, 'n_warmup': 30}
    bf.utils.set_generator(21)
    tt_m = bf.sample(den, dict(cfg), verbose=False, mesh=mesh8)
    assert len(tt_m.trace._carry.q.sharding.device_set) == 8
    bf.utils.set_generator(21)
    tt_s = bf.sample(den, dict(cfg), verbose=False, mesh=None)
    assert np.allclose(tt_m.samples, tt_s.samples, atol=1e-10)
    assert np.array_equal(tt_m.trace._stats_arrays['tree_depth'],
                          tt_s.trace._stats_arrays['tree_depth'])
