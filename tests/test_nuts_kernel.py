"""The flat-loop NUTS tree kernel (``samplers/nuts.py``) — the only NUTS
path — at the transition level and through the ``bf.sample`` driver.

Checks: per-transition invariants in both dtypes, stationarity on a known
target, dual averaging + Welford adaptation under the driver, and that the
driver's random stream does not depend on how a run is cut into chunks.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import bayesfast_jax as bf
from bayesfast_jax import config
from bayesfast_jax.samplers.metrics import init_diag_metric
from bayesfast_jax.samplers.nuts import nuts_transition_batched


@pytest.fixture
def _dtype(request):
    """Run a test under float32 (x64 off) or float64 (x64 on)."""
    prev = jax.config.jax_enable_x64
    jax.config.update('jax_enable_x64', request.param == 'float64')
    config.set_dtype(None)
    yield jnp.dtype(request.param)
    jax.config.update('jax_enable_x64', prev)
    config.set_dtype(None)


def _std_normal_lpg():
    return jax.vmap(jax.value_and_grad(lambda x: -0.5 * jnp.sum(x ** 2)))


@pytest.mark.parametrize('_dtype', ['float32', 'float64'], indirect=True)
def test_transition_invariants(_dtype):
    D, C, max_depth = 6, 128, 8
    lpg_b = _std_normal_lpg()
    metric = init_diag_metric(jnp.zeros(D, _dtype), jnp.ones(D, _dtype))
    key = jax.random.PRNGKey(1)
    q0 = jax.random.normal(key, (C, D), _dtype)
    step = jax.jit(lambda k, q: nuts_transition_batched(
        k, q, metric, jnp.asarray(0.4, _dtype), lpg_b, max_depth, 1000.0))
    q, st = step(key, q0)
    assert q.shape == (C, D) and q.dtype == _dtype
    assert np.all(np.isfinite(np.asarray(q)))
    depth = np.asarray(st.tree_depth)
    size = np.asarray(st.tree_size)
    assert np.all(depth >= 1) and np.all(depth <= max_depth)
    # leaves evaluated never exceed the full tree of the reached depth
    assert np.all(size >= 1) and np.all(size <= 2 ** depth)
    acc = np.asarray(st.mean_tree_accept)
    assert np.all((acc >= 0) & (acc <= 1)) and acc.mean() > 0.5
    assert not np.asarray(st.diverging).any()
    # the reported logp is the density at the proposal
    lp, _ = lpg_b(q)
    tol = 1e-4 if _dtype == jnp.float32 else 1e-10
    assert np.allclose(np.asarray(lp), np.asarray(st.logp), atol=tol)
    # same key, same start: the transition is deterministic
    q2, _ = step(key, q0)
    assert np.array_equal(np.asarray(q), np.asarray(q2))


def test_transition_chain_is_stationary():
    """Repeated transitions at a fixed step size and metric sample the
    exact N(0, I) target (moments from 256 chains x 30 kept draws)."""
    D, C, n_iter = 4, 256, 60
    lpg_b = _std_normal_lpg()
    metric = init_diag_metric(jnp.zeros(D), jnp.ones(D))
    step = jax.jit(lambda k, q: nuts_transition_batched(
        k, q, metric, jnp.asarray(0.5), lpg_b, 8, 1000.0))
    q = jax.random.normal(jax.random.PRNGKey(2), (C, D))
    key = jax.random.PRNGKey(4)
    kept, acc = [], []
    for i in range(n_iter):
        key, sub = jax.random.split(key)
        q, st = step(sub, q)
        if i >= n_iter // 2:
            kept.append(np.asarray(q))
            acc.append(np.asarray(st.mean_tree_accept))
    tail = np.concatenate(kept)
    # standard errors: ~1/sqrt(7680 / tau) with tau ~ 1 for NUTS here
    assert np.abs(tail.mean(0)).max() < 0.1
    assert np.abs(tail.var(0) - 1.0).max() < 0.15
    assert 0.7 < np.mean(acc) < 1.0


def test_sample_driver_adapts_step_and_metric():
    """bf.sample end to end: dual averaging moves the per-chain step size
    during warmup and freezes it after; the Welford metric converges to
    the target variance; the draws match the target's moments."""
    D = 4
    den = bf.DensityLite(logp=lambda x: -jnp.sum((x - 1.5) ** 2),
                         input_size=D)
    bf.utils.set_generator(5)
    n_warmup = 150
    tt = bf.sample(den, {'n_chain': 128, 'n_iter': 300,
                         'n_warmup': n_warmup}, verbose=False)
    st = tt.trace._stats_arrays
    eps = st['step_size']
    # warmup adapts (the step changes), post-warmup holds it fixed
    assert np.any(np.abs(np.diff(eps[:, :n_warmup], axis=1)) > 0)
    assert np.all(eps[:, n_warmup:] == eps[:, n_warmup:n_warmup + 1])
    assert np.all(st['warmup'][:, :n_warmup])
    assert not np.any(st['warmup'][:, n_warmup:])
    # logp = -(x - 1.5)^2 => var 0.5 per dim
    var = np.asarray(tt.trace._carry.metric.var)
    assert np.abs(np.median(var, axis=0) - 0.5).max() < 0.1
    s = tt.get(flatten=True)
    assert np.all(np.isfinite(s))
    assert np.abs(s.mean(0) - 1.5).max() < 0.1
    assert np.abs(s.var(0) - 0.5).max() < 0.1
    acc = st['mean_tree_accept'][:, n_warmup:].mean()
    assert 0.6 < acc < 0.95


def test_sample_stream_independent_of_chunking():
    """The chain keys advance once per transition inside the scan, so a
    run cut into chunks of 7 (straddling the warmup boundary) and one cut
    into chunks of 40 give the same draws."""
    D = 3
    den = bf.DensityLite(logp=lambda x: -0.5 * jnp.sum(x ** 2),
                         input_size=D, vectorized=True)
    cfg = {'n_chain': 8, 'n_iter': 80, 'n_warmup': 40}
    runs = []
    for n_update in (7, 40):
        bf.utils.set_generator(12)
        tt = bf.sample(den, dict(cfg), verbose=False, n_update=n_update)
        runs.append(tt.samples)
    assert np.array_equal(runs[0], runs[1])
