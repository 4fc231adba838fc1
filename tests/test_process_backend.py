"""Process-pool backend for GIL-bound external likelihoods.

The reference farms seconds-per-call cosmosis likelihoods over a
64-process pool (``bayesfast/core/sample.py:185-214``). A thread pool
cannot reproduce that for pure-Python models — they hold the GIL — so
``ParallelBackend(kind='processes')`` must scale them ~linearly. The fake
likelihood below BUSY-WAITS (holding the GIL) to make the distinction
observable: threads serialize it, processes don't.
"""

import time

import numpy as np
import pytest

import bayesfast_jax as bf
from bayesfast_jax.utils.parallel import (ParallelBackend, get_backend,
                                          set_backend)

_BUSY_S = 0.12


def _busy_logp(x):
    """Pure-Python GIL-holding 'external likelihood'."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < _BUSY_S:
        pass
    return np.array([-float(np.sum(np.asarray(x) ** 2))])


def _density():
    m_mod = bf.Module(fun=_busy_logp, input_vars='x', output_vars='logp',
                      input_shapes=[3], output_shapes=[1], traceable=False)
    return bf.Density(density_name='logp', module_list=[m_mod],
                      input_vars='x', input_shapes=[3])


@pytest.fixture
def _restore_backend():
    prev = get_backend()
    yield
    set_backend(prev)


def test_process_backend_map_basic(_restore_backend):
    set_backend((2, 'processes'))
    b = get_backend()
    assert b.kind == 'processes'
    out = b.map(np.square, [np.arange(3), np.arange(4)])
    assert np.array_equal(out[1], np.arange(4) ** 2)


def test_process_backend_scales_gil_bound_likelihood(_restore_backend):
    den = _density()
    x = np.random.default_rng(0).normal(size=(8, 3))

    set_backend(ParallelBackend(serial=True))
    t0 = time.perf_counter()
    vds_serial = den.fun(x, use_surrogate=False)
    t_serial = time.perf_counter() - t0

    set_backend((4, 'processes'))
    # warm the shared forkserver pool (one-time worker bootstrap +
    # module-import cost); the assertion below measures steady-state
    # scaling, which is what matters for the reference's
    # seconds-per-call external likelihoods
    get_backend().map(_busy_logp, [np.zeros(3)] * 4)
    t0 = time.perf_counter()
    vds_proc = den.fun(x, use_surrogate=False)
    t_proc = time.perf_counter() - t0

    # identical results
    for a, b in zip(vds_serial, vds_proc):
        assert np.allclose(a.fun['logp'], b.fun['logp'])
    # 8 busy-waits over 4 workers: ideal 0.25x; the loose 0.7x bound keeps
    # the assertion meaningful (threads CANNOT beat 1.0x here — the worker
    # holds the GIL) while tolerating a loaded CI box
    assert t_proc < 0.7 * t_serial, (t_serial, t_proc)


def test_process_backend_context_reuse(_restore_backend):
    # a `with` block pre-opens one pool shared by repeated maps
    with ParallelBackend(3, kind='processes') as b:
        r1 = b.map(_busy_logp, [np.ones(3)] * 3)
        r2 = b.map(_busy_logp, [np.zeros(3)] * 3)
    assert np.isclose(r1[0][0], -3.0) and np.isclose(r2[0][0], 0.0)


def test_process_backend_after_device_sampling(_restore_backend):
    """Forking a JAX-initialized parent is a latent
    deadlock. The 'forkserver' default must keep process pools usable
    AFTER device work has run in the parent."""
    import jax
    import jax.numpy as jnp

    assert ParallelBackend(kind='processes')._mp_context == 'forkserver'
    # real device work first, so the parent's runtime threads are live
    _ = jax.jit(lambda v: jnp.sum(v * v))(
        jnp.arange(64.0)).block_until_ready()
    with ParallelBackend(2, kind='processes') as b:
        out = b.map(_busy_logp, [np.ones(3)] * 4)
    assert np.isclose(out[0][0], -3.0)


def _worker_platform(_):
    import os
    import jax
    return (os.environ.get('JAX_PLATFORMS'), jax.config.jax_platforms,
            jax.default_backend())


@pytest.mark.parametrize('mp_context', ['forkserver', 'spawn'])
def test_process_workers_report_cpu_backend(_restore_backend, monkeypatch,
                                            mp_context):
    """Pool workers are pinned to JAX's CPU backend whatever the parent's
    environment says, so a worker can never reserve the accelerator the
    parent process holds."""
    monkeypatch.setenv('JAX_PLATFORMS', '')
    with ParallelBackend(2, kind='processes', mp_context=mp_context) as b:
        out = b.map(_worker_platform, [0, 1])
    assert out == [('cpu', 'cpu', 'cpu')] * 2
