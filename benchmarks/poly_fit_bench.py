"""DES-scale polynomial surrogate benchmark.

The reference's hardest surrogate workload is the DES-Y1 configuration
(``examples/des-y1-w-cosmosis.ipynb`` cell 18): 27 input parameters, a
457-dim output data vector, fitted per refit iteration with a linear block
on all dims plus a quadratic block on a 9-dim subset, then evaluated inside
every surrogate-NUTS leapfrog. The reference loops the 457 output dims
through scipy lstsq serially (``modules/poly.py:529-587``) and evaluates
through OpenMP Cython kernels (``modules/_poly.pyx``).

Here: one multi-RHS lstsq on device for the fit; batched feature-matmul
eval. This script reports fit wall time and eval throughput, plus a
full-width cubic-3 variant (the O(d^3) feature blowup case).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfast_jax.modules import PolyConfig, PolyModel  # noqa: E402


def bench_config(name, model, D, n_fit, n_eval_batch, rng):
    x = rng.normal(size=(n_fit, D))
    w_true = rng.normal(size=model.output_size)

    def truth(x):
        # smooth nonlinear target the polynomial can chase
        base = np.tanh(x @ rng.standard_normal((D, model.output_size)) / D)
        return base + 0.1 * (x ** 2) @ np.abs(
            rng.standard_normal((D, model.output_size))) / D

    rng2 = np.random.default_rng(1)
    Wl = rng2.normal(size=(D, model.output_size)) / np.sqrt(D)
    y = x @ Wl + 0.05 * (x ** 2) @ (Wl ** 2)

    t0 = time.time()
    model.fit(x, y)
    t_fit_first = time.time() - t0  # includes lstsq program compilation
    # steady-state refit (what Recipe repeats every iteration)
    t0 = time.time()
    model.fit(x, y)
    t_fit = time.time() - t0

    xe = jnp.asarray(rng.normal(size=(n_eval_batch, D)), jnp.float32)
    params = model.dynamic_params()
    f = jax.jit(lambda p, xx: jax.vmap(
        lambda v: model._fun_traced(p, v))(xx))
    out = f(params, xe)
    jax.block_until_ready(out)
    ts = []
    for _ in range(7):
        t0 = time.time()
        out = f(params, xe)
        jax.block_until_ready(out)
        ts.append(time.time() - t0)
    t_eval = float(np.median(ts))
    evals_per_sec = n_eval_batch / t_eval
    print(json.dumps({
        'bench': name, 'n_param_per_out': int(model.n_param),
        'fit_sec': round(t_fit, 3),
        'fit_first_sec_incl_compile': round(t_fit_first, 3),
        'eval_batch': n_eval_batch,
        'eval_sec': round(t_eval, 5),
        'surrogate_evals_per_sec': round(evals_per_sec, 1),
    }))


def main():
    rng = np.random.default_rng(0)

    # DES cell-18 configuration: linear(27) + quadratic on 9 dims, 457 outs
    D, K = 27, 457
    confs = [PolyConfig('linear'),
             PolyConfig('quadratic', input_mask=np.arange(9))]
    m = PolyModel(confs, input_size=D, output_size=K, scope=(0, 1),
                  input_vars='x', output_vars='m')
    bench_config('des_linear_quad9_457out', m, D, n_fit=2000,
                 n_eval_batch=4096, rng=rng)

    # full cubic-3 on 16 dims (n_param ~ 1 + 16 + 136 + 256? masks full)
    D2, K2 = 16, 64
    m2 = PolyModel('cubic-3', input_size=D2, output_size=K2, scope=(0, 1),
                   input_vars='x', output_vars='m')
    bench_config('cubic3_full_16in_64out', m2, D2,
                 n_fit=2 * m2.n_param, n_eval_batch=4096, rng=rng)


if __name__ == '__main__':
    from _common import device_report, require_gpu, setup_cache
    setup_cache()
    require_gpu()
    print(json.dumps({'device': device_report()}))
    main()
