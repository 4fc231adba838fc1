"""Device KDE cdf (``ops/kde.py``) against a plain scipy reference.

Both entry points pad: ``kde_cdf_device`` pads queries to 512 and data to
1024, ``kde_cdf_batch`` pads data to whole 1024-blocks. Sizes on and off
those multiples must give the same sums as the unpadded reference.
"""

import numpy as np
import pytest
from scipy.special import ndtr

from bayesfast_jax.ops.kde import kde_cdf_batch, kde_cdf_device


def _reference(x, data, w, h):
    return ndtr((x[:, None] - data[None, :]) / h) @ w


def _case(n_x, n_data, seed):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=n_data) * 1.3 + 0.2
    w = rng.uniform(0.5, 1.5, n_data)
    w /= w.sum()
    x = np.linspace(-5, 5, n_x)
    return x, data, w


@pytest.mark.parametrize('n_x,n_data', [(512, 1024), (300, 1000),
                                        (1030, 2053)])
def test_kde_cdf_device_matches_reference(n_x, n_data):
    x, data, w = _case(n_x, n_data, n_x)
    h = 0.3
    out = np.asarray(kde_cdf_device(x, data, w, h))
    assert out.shape == (n_x,)
    assert np.allclose(out, _reference(x, data, w, h), atol=1e-12)


@pytest.mark.parametrize('n_data', [2048, 1500])
def test_kde_cdf_batch_matches_reference(n_data):
    rng = np.random.default_rng(n_data)
    D, M = 3, 40
    data = rng.normal(size=(D, n_data)) * np.array([[0.5], [1.0], [2.0]])
    w = rng.uniform(0.5, 1.5, n_data)
    w /= w.sum()
    h = np.array([0.1, 0.3, 0.6])
    x = rng.normal(size=(D, M)) * 2
    out = np.asarray(kde_cdf_batch(x, data, w, h))
    ref = np.stack([_reference(x[d], data[d], w, h[d]) for d in range(D)])
    assert out.shape == (D, M)
    assert np.allclose(out, ref, atol=1e-12)
