"""Benchmark: batched NUTS on the 32-d Banana density (BASELINE.md flagship).

Reference anchor: the bayesfast banana-gbs example runs 8 chains on an
8-process Cori node at ~11 warmup iterations/sec/chain (~88 it/s aggregate).
Here the same density (D=32, Q=0.01, hard bounds [-15, 15], random SO(32)
rotation, identical NUTS configuration) runs as one jitted float32 program
with the chain axis batched on one GPU. Without a GPU it exits non-zero.

The chains start from the honest raw Sobol cold start: the framework's
start-descent + reasonable-step probe (exact-n_call-accounted features, see
``core.sample``) handle the |logp| ~ 3e6 landing zone. The package forces
float32-accurate matmuls (``config.set_matmul_precision``), so the rotation
adds no reduced-precision gradient noise.

Warmup throughput is the headline (vs_baseline); "extra" carries the device
(JAX's platform, kind and count, and ``nvidia-smi``'s name and power
limit), post-warmup ESS/sec with a cross-chain-group error bar (the
BASELINE.json north-star metric), tree statistics, leapfrogs/sec, and a
measured roofline: the kernel's implied memory traffic per second against
the device's *achieved* copy bandwidth measured in the same process.

Prints a device line, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "extra"}.
"""

import json
import os
import time

import numpy as np


def _timed(f, x, reps):
    """Best-of-3 mean seconds per call of ``x = f(x)``, synchronized with
    ``block_until_ready`` (one warm call compiles first)."""
    import jax
    x = jax.block_until_ready(f(x))
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            x = f(x)
        jax.block_until_ready(x)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def _measured_copy_bw(jnp, reps=8):
    """Achieved device-memory streaming bandwidth (read + write, GB/s) of a
    full-array multiply over a 1 GiB float32 buffer."""
    import jax
    n_bytes = 1 << 30
    x = jnp.ones(n_bytes // 4, jnp.float32)
    t = _timed(jax.jit(lambda a: a * 1.0000001), x, reps)
    return 2 * n_bytes / t / 1e9


def _measured_matmul_tflops(jnp, reps=8):
    """Achieved float32 matmul rate (TFLOP/s) at the session's matmul
    precision: the package forces float32-accurate matmuls, so a nominal
    reduced-precision peak is not the ceiling for this workload."""
    import jax
    n = 8192
    w = jnp.eye(n, dtype=jnp.float32) * 1.0000001
    x = jnp.ones((n, n), jnp.float32)
    t = _timed(jax.jit(lambda a: a @ w), x, reps)
    return 2 * n ** 3 / t / 1e12


def banana_density(dtype=None):
    """The 32-d rotated banana (D=32, Q=0.01, hard bounds [-15, 15], SO(32)
    rotation from ``random_state=0``) as a ``DensityLite`` whose rotation is
    held in ``dtype`` (default: the package's active dtype)."""
    import jax.numpy as jnp
    import bayesfast_jax as bf
    from scipy.stats import special_ortho_group

    D, Q = 32, 0.01
    lower = np.full(D, -15.)
    upper = np.full(D, 15.)
    bound = np.stack((lower, upper)).T
    const = float(np.sum(np.log(upper - lower)))
    dtype = bf.config.get_dtype() if dtype is None else dtype
    A = jnp.asarray(special_ortho_group.rvs(D, random_state=0), dtype)
    # even-pair mask: the same math as z[::2] / z[1::2] without strided
    # slices
    even = jnp.asarray((np.arange(D) % 2) == 0, dtype)

    def logp(x):
        z = x @ A.T
        zn = jnp.roll(z, -1, axis=-1)
        t = (z * z - zn) ** 2 / Q + (z - 1.0) ** 2
        return -jnp.sum(t * even) - const

    return bf.DensityLite(logp=logp, input_size=D, input_scales=bound,
                          hard_bounds=True)


def main():
    import jax
    import jax.numpy as jnp
    from benchmarks._common import device_report, require_gpu, setup_cache
    setup_cache()
    require_gpu()
    device = device_report()
    print(f"device: {device['kind']} x{device['count']}, "
          f"nvidia-smi: {device['nvidia_smi']}", flush=True)
    import bayesfast_jax as bf
    from bayesfast_jax.utils.acor import effective_sample_size

    n_chain = int(os.environ.get('BENCH_N_CHAIN', 1024))
    n_warmup = int(os.environ.get('BENCH_N_WARMUP', 400))
    n_post = int(os.environ.get('BENCH_N_POST', 300))
    D = 32

    bf.utils.set_generator(32)
    den = banana_density(jnp.float32)

    trace = bf.NTrace(n_chain=n_chain, n_iter=n_warmup + n_post,
                      n_warmup=n_warmup)

    # compile + start-descent + probe warm pass (2 iterations)
    tt = bf.sample(den, trace, n_run=2, verbose=False, n_update=2)

    t0 = time.time()
    tt = bf.sample(den, tt, n_run=n_warmup - 2, verbose=False, n_update=100)
    dt_warm = time.time() - t0

    # post phase in 3 timed segments: the segment-rate spread is the
    # run-to-run stability bar for the headline numbers
    seg_rates = []
    dt_post = 0.0
    seg = n_post // 3
    for i in range(3):
        n_seg = seg if i < 2 else n_post - 2 * seg
        t0 = time.time()
        tt = bf.sample(den, tt, n_run=n_seg, verbose=False,
                       n_update=n_seg)
        dt = time.time() - t0
        seg_rates.append(n_chain * n_seg / dt)
        dt_post += dt

    warm_iters_per_sec = n_chain * (n_warmup - 2) / dt_warm
    baseline = 88.0  # 8 chains x ~11 warmup it/s/chain on the Cori node

    # post-warmup effective samples per second on this one device, with a
    # cross-group error bar: ESS is estimated independently on 8 disjoint
    # chain groups; the total is their sum and the quoted error is the
    # group scatter propagated to the sum
    s = tt.get(flatten=False)                      # (chain, iter, dim)
    n_grp = 8
    gs = n_chain // n_grp
    ess_g = np.array([
        np.sum(effective_sample_size(s[g * gs:(g + 1) * gs])) / s.shape[-1]
        for g in range(n_grp)])
    ess = float(np.sum(ess_g))
    ess_err = float(np.std(ess_g, ddof=1) * np.sqrt(n_grp))
    ess_per_sec = ess / dt_post
    # integrated autocorrelation time and the emcee-style N >= 50 tau
    # reliability check for the autocorrelation fit
    tau = s.shape[1] / max(ess / n_chain, 1e-12)
    ess_reliable = bool(s.shape[1] >= 50 * tau)

    st = tt.trace._stats_arrays
    depth_post = float(np.mean(st['tree_depth'][:, n_warmup:]))
    size_post = float(np.mean(st['tree_size'][:, n_warmup:]))
    leapfrogs_per_sec = n_chain * n_post * size_post / dt_post

    # ---- measured roofline (memory side; the only matmul is the
    # (C,32)x(32,32) rotation) ----
    # implied bytes per tree-leaf iteration, from the kernel layout
    # (samplers/nuts.py): leapfrog reads+writes the 8-vector (D, C) state
    # twice over (Kahan q/p + v + grad) ~ 16 D C f32 transfers; the fused
    # first merge / frame push move ~2 frames of (3D+1+D+2) rows; cur-select
    # rewrites the 8-vector state once more.
    frame_rows = 4 * D + 3
    bytes_per_leaf = (16 * D + 8 * D + 2 * frame_rows) * 4
    implied_gbs = leapfrogs_per_sec * bytes_per_leaf / 1e9
    copy_bw = _measured_copy_bw(jnp)

    # ---- FLOP side: each leaf runs the (C, D) x (D, D) rotation twice
    # (value + grad), 2 flops/MAC, per chain -> 4 D^2 flops/leaf/chain.
    # The share is quoted against the device's *measured* f32 matmul rate
    # at the same (forced-accurate) precision, not a nominal peak.
    implied_tflops = leapfrogs_per_sec * 4 * D * D / 1e12
    mm_rate = _measured_matmul_tflops(jnp)

    print(json.dumps({
        'metric': 'banana32_nuts_warmup_iters_per_sec',
        'value': round(warm_iters_per_sec, 2),
        'unit': 'iterations/sec (all chains, 1 device)',
        'vs_baseline': round(warm_iters_per_sec / baseline, 3),
        'extra': {
            'n_chain': n_chain,
            'device': device,
            'ess_per_sec_per_device': round(ess_per_sec, 1),
            'ess_per_sec_err': round(ess_err / dt_post, 1),
            'ess_total': round(ess, 1),
            'tau_iterations': round(tau, 2),
            'ess_estimate_reliable_n_ge_50tau': ess_reliable,
            'post_iters_per_sec': round(n_chain * n_post / dt_post, 1),
            'post_iters_per_sec_segments': [round(r, 1)
                                            for r in seg_rates],
            'mean_tree_depth_post': round(depth_post, 2),
            'mean_tree_size_post': round(size_post, 1),
            'leapfrogs_per_sec': round(leapfrogs_per_sec, 0),
            'implied_mem_gb_per_sec': implied_gbs,
            'measured_copy_bw_gb_per_sec': copy_bw,
            'mem_share_of_measured_copy': implied_gbs / copy_bw,
            'implied_matmul_tflops': implied_tflops,
            'measured_matmul_tflops': mm_rate,
            'matmul_share_of_measured': implied_tflops / mm_rate,
            'n_call': int(tt.n_call),
        },
    }))


if __name__ == '__main__':
    main()
