"""Chain-scaling study: throughput and ESS/sec per device vs n_chain.

The single-device value proposition of this package is that one GPU runs
thousands of lockstep chains; this sweep measures where the device actually
saturates on two BASELINE.md anchors (banana-32 and funnel-16, float32) and
what the per-iteration cost looks like at the knee. Each invocation measures
ONE (target, n_chain) point (the flat-tree NUTS program takes minutes to
compile per shape — the persistent cache in ``.jax_cache`` makes repeats
cheap) and appends a JSON record to ``benchmarks/results.jsonl``:

    python benchmarks/scaling_bench.py banana32 4096
    python benchmarks/scaling_bench.py funnel16 65536

Reported per point: warmup + post iteration throughput, leapfrogs/sec,
ESS/sec (with cross-group error), mean tree size, and the implied memory
traffic against the device's measured streaming bandwidth (see
``bench.py``). Exits non-zero without a GPU.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from _common import device_report, require_gpu, setup_cache  # noqa: E402

setup_cache()
require_gpu()


def make_density(target):
    import jax.numpy as jnp
    import bayesfast_jax as bf

    if target == 'banana32':
        from scipy.stats import special_ortho_group
        D, Q = 32, 0.01
        bound = np.stack((np.full(D, -15.), np.full(D, 15.))).T
        const = float(D * np.log(30.))
        A = jnp.asarray(special_ortho_group.rvs(D, random_state=0),
                        jnp.float32)

        def logp(x):
            z = x @ A.T
            return (-jnp.sum((z[::2] ** 2 - z[1::2]) ** 2 / Q
                             + (z[::2] - 1) ** 2) - const)
        extra = {}
    elif target == 'funnel16':
        D, a, b = 16, 1., 0.5
        lower = np.full(D, -30.)
        upper = np.full(D, 30.)
        lower[0], upper[0] = -4, 4
        bound = np.stack((lower, upper)).T
        const = float(np.sum(np.log(upper - lower)))

        def logp(x):
            _a = -0.5 * x[0] ** 2 / a ** 2
            _b = -0.5 * jnp.sum(x[1:] ** 2) * jnp.exp(-2 * b * x[0])
            _c = (-0.5 * jnp.log(2 * jnp.pi * a ** 2)
                  - 0.5 * (D - 1) * jnp.log(2 * jnp.pi) - (D - 1) * b * x[0])
            return _a + _b + _c - const
        extra = {'target_accept': 0.95}
    else:
        raise SystemExit(f'unknown target {target}')
    den = bf.DensityLite(logp=logp, input_size=bound.shape[0],
                         input_scales=bound, hard_bounds=True)
    return den, extra, bound.shape[0]


def main():
    target = sys.argv[1] if len(sys.argv) > 1 else 'banana32'
    n_chain = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    n_warmup = int(os.environ.get('BENCH_N_WARMUP', 400))
    n_post = int(os.environ.get('BENCH_N_POST', 300))

    import jax.numpy as jnp  # noqa: F401
    import bayesfast_jax as bf
    from bayesfast_jax.utils.acor import effective_sample_size
    import bench

    den, extra, D = make_density(target)
    bf.utils.set_generator(32)
    trace = bf.NTrace(n_chain=n_chain, n_iter=n_warmup + n_post,
                      n_warmup=n_warmup, **extra)
    tt = bf.sample(den, trace, n_run=2, verbose=False, n_update=2)
    t0 = time.time()
    tt = bf.sample(den, tt, n_run=n_warmup - 2, verbose=False, n_update=25)
    dt_warm = time.time() - t0
    t0 = time.time()
    tt = bf.sample(den, tt, n_run=n_post, verbose=False, n_update=25)
    dt_post = time.time() - t0

    s = tt.get(flatten=False)
    n_grp = 8
    gs = n_chain // n_grp
    ess_g = np.array([
        np.sum(effective_sample_size(s[g * gs:(g + 1) * gs])) / D
        for g in range(n_grp)])
    ess = float(np.sum(ess_g))
    ess_err = float(np.std(ess_g, ddof=1) * np.sqrt(n_grp))

    st = tt.trace._stats_arrays
    size_post = float(np.mean(st['tree_size'][:, n_warmup:]))
    depth_post = float(np.mean(st['tree_depth'][:, n_warmup:]))
    lf_per_sec = n_chain * n_post * size_post / dt_post
    frame_rows = 4 * D + 3
    bytes_per_leaf = (16 * D + 8 * D + 2 * frame_rows) * 4
    implied_gbs = lf_per_sec * bytes_per_leaf / 1e9
    copy_bw = bench._measured_copy_bw(jnp)
    # FLOP side: banana32's density is 2 (C,D)x(D,D) rotations per leaf,
    # so its roofline is the measured matmul rate. funnel16 has no matmul
    # at all — its ~10 D elementwise flops/leaf get a separate
    # implied_elementwise_tflops field and the (multi-second) matmul
    # micro-bench is skipped for it.
    has_matmul = target == 'banana32'
    if has_matmul:
        flops_per_leaf = 4 * D * D
        implied_tflops = lf_per_sec * flops_per_leaf / 1e12
        mm_rate = bench._measured_matmul_tflops(jnp)
    else:
        implied_ew_tflops = lf_per_sec * 10 * D / 1e12

    rec = {
        'metric': f'scaling_{target}', 'device': device_report(),
        'n_chain': n_chain, 'dtype': 'float32',
        'warmup_iters_per_sec': round(n_chain * (n_warmup - 2) / dt_warm, 1),
        'post_iters_per_sec': round(n_chain * n_post / dt_post, 1),
        'leapfrogs_per_sec': round(lf_per_sec, 0),
        'ess_per_sec_per_device': round(ess / dt_post, 1),
        'ess_per_sec_err': round(ess_err / dt_post, 1),
        'mean_tree_depth_post': round(depth_post, 2),
        'mean_tree_size_post': round(size_post, 1),
        'implied_mem_gb_per_sec': implied_gbs,
        'measured_copy_bw_gb_per_sec': copy_bw,
        'mem_share_of_measured_copy': implied_gbs / copy_bw,
        'sample_wall_s': round(dt_warm + dt_post, 1),
    }
    if has_matmul:
        rec['implied_matmul_tflops'] = round(implied_tflops, 4)
        rec['measured_matmul_tflops'] = mm_rate
        rec['matmul_share_of_measured'] = implied_tflops / mm_rate
    else:
        rec['implied_elementwise_tflops'] = implied_ew_tflops
    print(json.dumps(rec))
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'results.jsonl')
    with open(path, 'a') as f:
        f.write(json.dumps(rec) + '\n')


if __name__ == '__main__':
    main()
