"""Micro-benchmark: SIT stacked-flow evaluation cost, float64 vs float32.

The SIT splines are FIT from float32 KDE-cdf values regardless of the run
dtype, so evaluating the flow in f32 loses nothing that the fit had; this
bench measures the wall gap between a float64 and a float32 flow program
at the ring-64 anchor's shape, which decides whether the float32
``flow_dtype`` default is worth keeping. Exits non-zero without a GPU.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from _common import device_report, require_gpu, setup_cache, sync

setup_cache()
require_gpu()

import jax
import jax.numpy as jnp

jax.config.update('jax_enable_x64', True)

from bayesfast_jax.transforms.sit import _flow_forward, _flow_backward


def bench(dtype, L=10, D=64, M=160, n=65536, reps=3):
    rng = np.random.default_rng(0)
    # monotone-ish padded splines: increasing knots, linear-ish coefficients
    xs = np.sort(rng.normal(size=(L, D, M)), axis=-1) * 3
    ys = np.sort(rng.normal(size=(L, D, M)), axis=-1) * 3
    cs = np.zeros((L, D, M + 1, 4))
    cs[..., 2] = 1.0
    cs[..., 3] = np.concatenate(
        [ys[..., :1], (ys[..., :-1] + ys[..., 1:]) / 2], axis=-1)
    m = np.full((L, D), M, np.int32)
    A = np.stack([np.eye(D)] * L)
    mu = np.zeros((L, D))
    x = rng.normal(size=(n, D))

    args_f = [jnp.asarray(a, dtype) for a in (xs, cs)]
    args_b = [jnp.asarray(a, dtype) for a in (xs, ys, cs)]
    m_j = jnp.asarray(m)
    A_j = jnp.asarray(A, dtype)
    mu_j = jnp.asarray(mu, dtype)
    x_j = jnp.asarray(x, dtype)

    y, lj = _flow_forward(args_f[0], args_f[1], m_j, A_j, mu_j, x_j)
    sync(y)
    t0 = time.time()
    for _ in range(reps):
        y, lj = _flow_forward(args_f[0], args_f[1], m_j, A_j, mu_j, x_j)
    sync(y)
    fwd = (time.time() - t0) / reps

    xb, ljb = _flow_backward(args_b[0], args_b[1], args_b[2], m_j, A_j,
                             mu_j, x_j)
    sync(xb)
    t0 = time.time()
    for _ in range(reps):
        xb, ljb = _flow_backward(args_b[0], args_b[1], args_b[2], m_j,
                                 A_j, mu_j, x_j)
    sync(xb)
    bwd = (time.time() - t0) / reps
    return fwd, bwd


if __name__ == '__main__':
    import json
    f64 = bench(jnp.float64)
    f32 = bench(jnp.float32)
    print(json.dumps({
        'metric': 'flow_dtype_bench', 'shape': 'L10 D64 M160 n65536',
        'device': device_report(),
        'fwd_f64_s': round(f64[0], 3), 'bwd_f64_s': round(f64[1], 3),
        'fwd_f32_s': round(f32[0], 3), 'bwd_f32_s': round(f32[1], 3),
        'fwd_speedup': round(f64[0] / f32[0], 1),
        'bwd_speedup': round(f64[1] / f32[1], 1)}))
