"""Full reference-anchor benchmark suite (BASELINE.md rows).

Runs every config the reference publishes numbers for — funnel-16,
ring-64, cauchy-48, banana-32 (GBS evidence parity + warmup throughput),
the 2d-donut surrogate Recipe (true-model call budget), and the DES-scale
polynomial surrogate — on the attached GPU, and appends one JSON line per
config to ``benchmarks/results.jsonl`` (not committed: the place of record
for speed is ``PERF.md``).

Evidence-parity configs run float64 (matching the committed examples; the
float32 tier is validated separately in ``tests/test_float32.py``), with
the per-chain reference sampler configuration (2500 iterations, 1000
warmup) at N_CHAIN chains.

Usage:
    python benchmarks/suite.py --configs funnel,ring,cauchy,banana
    python benchmarks/suite.py --configs donut,des
"""

import argparse
import sys
sys.path.insert(0, __import__('os').path.dirname(__import__('os').path.dirname(__import__('os').path.abspath(__file__))))
import json
import os
import time

import numpy as np

RESULTS_PATH = os.path.join(os.path.dirname(__file__), 'results.jsonl')

# BASELINE.md anchors: (fiducial logz, published logz, published err,
#                       reference aggregate warmup it/s on the Cori node)
ANCHORS = {
    'banana': (-127.3640, -127.2756, 0.0534, 88.),
    'funnel': (-63.4988, -63.4788, 0.0170, 1120.),
    'ring': (-114.492, -114.4726, 0.0649, 480.),
    'cauchy': (-254.627, -254.6362, 0.0935, 120.),
}


def _density(name):
    import jax.numpy as jnp
    import bayesfast_jax as bf

    if name == 'banana':
        from scipy.stats import special_ortho_group
        D, Q = 32, 0.01
        bound = np.stack((np.full(D, -15.), np.full(D, 15.))).T
        const = float(D * np.log(30.))
        # captured in the ACTIVE framework dtype: under x64 a float64
        # rotation would silently promote the float32 fill-tier sampling
        A = bf.config.asarray(special_ortho_group.rvs(D, random_state=0))

        def logp(x):
            z = x @ A.T
            return (-jnp.sum((z[::2] ** 2 - z[1::2]) ** 2 / Q
                             + (z[::2] - 1) ** 2) - const)
        extra = {}
    elif name == 'funnel':
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
    elif name == 'ring':
        D, a, b = 64, 2., 1.
        bound = np.stack((np.full(D, -5.), np.full(D, 5.))).T
        const = float(D * np.log(10.))

        def logp(x):
            x2 = x * x
            x2s = jnp.concatenate((x2[-1:], x2, x2[:1]))
            return -jnp.sum((x2s[:-2] + x2s[1:-1] - a) ** 2 / b) - const
        extra = {}
    elif name == 'cauchy':
        D, a = 48, 5.
        bound = np.stack((np.full(D, -100.), np.full(D, 100.))).T
        const = float(D * np.log(200.))

        def logp(x):
            _a = 1 / ((x + a) ** 2 + 1)
            _b = 1 / ((x - a) ** 2 + 1)
            return (jnp.sum(jnp.log(_a + _b)) + D * jnp.log(0.5 / jnp.pi)
                    - const)
        extra = {}
    else:
        raise ValueError(name)
    den = bf.DensityLite(logp=logp, input_size=bound.shape[0],
                         input_scales=bound, hard_bounds=True)
    return den, extra


def run_gbs_config(name, n_chain, n_iter, n_warmup, dtype='float64',
                   mixed_warmup=False):
    """One evidence anchor. ``dtype='float32'`` is the fill tier: sampling
    runs in float32 at large chain counts, while the evidence arithmetic
    (bridge root solve, autocorrelation errors, SIT host bookkeeping)
    stays float64 on the host as always.

    ``mixed_warmup=True`` (float64 only) runs the ADAPTIVE warmup in
    float32 (adaptation only tunes step size and metric — statistically
    precision-insensitive), then warm-starts the float64 posterior phase
    from the adapted step size, metric and final positions
    (``_get_step_size``/``_get_metric``, the reference's own warm-start
    mechanism) with a short float64 re-adapt window. Posterior samples and
    the evidence arithmetic are full float64; only the discarded tuning
    iterations run in float32. Warmup throughput counts BOTH the f32
    warmup and the f64 re-adapt window."""
    import jax
    import bayesfast_jax as bf
    from bayesfast_jax.utils.acor import effective_sample_size, rhat

    fiducial, pub_logz, pub_err, ref_its = ANCHORS[name]
    if dtype == 'float32':
        import jax.numpy as jnp
        bf.config.set_dtype(jnp.float32)
    den, extra = _density(name)
    bf.utils.set_generator(sum(map(ord, name)))

    if mixed_warmup:
        import jax.numpy as jnp
        from bayesfast_jax.samplers.sample_trace import (_get_step_size,
                                                         _get_metric)
        assert dtype == 'float64'
        # ---- float32 adaptive warmup ----
        bf.config.set_dtype(jnp.float32)
        den32, extra32 = _density(name)
        trace32 = bf.NTrace(n_chain=n_chain, n_iter=n_warmup + 2,
                            n_warmup=n_warmup, **extra32)
        tt32 = bf.sample(den32, trace32, n_run=2, verbose=False, n_update=2)
        t0 = time.time()
        tt32 = bf.sample(den32, tt32, n_run=n_warmup - 2, verbose=False,
                         n_update=100)
        dt_warm = time.time() - t0
        tt32 = bf.sample(den32, tt32, n_run=2, verbose=False)
        step = _get_step_size(tt32)
        metric = _get_metric(tt32, 'diag', from_samples=False)
        x_last = tt32.get(original_space=True, flatten=False)[:, -1, :]
        n_call32 = int(tt32.n_call)
        bf.config.set_dtype(None)
        # ---- float64 posterior phase, warm-started with a SHORT f64
        # re-adapt window (per-chain step sizes re-settle from the
        # f32-adapted scalar start — freezing to the mean step collapses
        # heterogeneous-step targets like the funnel). The re-adapt runs
        # in length-2 scan chunks, reusing the untimed warm pass's
        # compiled program, so the timed window holds no XLA compile —
        # the same compile-exclusion protocol as every other row.
        n_readapt = 100
        trace = bf.NTrace(n_chain=n_chain,
                          n_iter=(n_iter - n_warmup) + n_readapt,
                          n_warmup=n_readapt,
                          x_0=np.asarray(x_last, np.float64),
                          step_size=step, metric=metric, **extra)
        tt = bf.sample(den, trace, n_run=2, verbose=False, n_update=2)
        t0 = time.time()
        tt = bf.sample(den, tt, n_run=n_readapt - 2, verbose=False,
                       n_update=2)
        dt_warm += time.time() - t0
        n_warmup_eff = (n_warmup - 2) + (n_readapt - 2)
        t0 = time.time()
        tt = bf.sample(den, tt, n_run=n_iter - n_warmup, verbose=False,
                       n_update=100)
        dt_post = time.time() - t0
    else:
        trace = bf.NTrace(n_chain=n_chain, n_iter=n_iter,
                          n_warmup=n_warmup, **extra)
        # warm pass: compile + descent + probe (excluded from throughput)
        tt = bf.sample(den, trace, n_run=2, verbose=False, n_update=2)
        t0 = time.time()
        tt = bf.sample(den, tt, n_run=n_warmup - 2, verbose=False,
                       n_update=100)
        dt_warm = time.time() - t0
        n_warmup_eff = n_warmup - 2
        t0 = time.time()
        tt = bf.sample(den, tt, n_run=n_iter - n_warmup, verbose=False,
                       n_update=100)
        dt_post = time.time() - t0

    s = tt.get(flatten=False)
    ess = float(np.sum(effective_sample_size(s)) / s.shape[-1])
    r = float(np.max(rhat(s)))

    t0 = time.time()
    gbs = bf.GBS(f_call=0.05, n_q_max=100_000)
    logz, err = gbs(tt, den.logp)
    dt_ev = time.time() - t0
    gbs_profile = getattr(gbs, 'last_profile', None)

    if dtype == 'float32':
        bf.config.set_dtype(None)
    rec = {
        'config': name, 'dtype': dtype, 'n_chain': n_chain,
        'n_iter': n_iter, 'n_warmup': n_warmup,
        'warmup_iters_per_sec': round(n_chain * n_warmup_eff / dt_warm, 1),
        'ref_warmup_iters_per_sec': ref_its,
        'speedup_vs_ref': round(
            n_chain * n_warmup_eff / dt_warm / ref_its, 1),
        'ess_per_sec_per_device': round(ess / dt_post, 1),
        'rhat_max': round(r, 4),
        'logz': round(float(logz), 4), 'logz_err': round(float(err), 4),
        'fiducial': fiducial,
        'published': [pub_logz, pub_err],
        'sigma_off_fiducial': round(abs(logz - fiducial) / err, 2),
        'gbs_wall_s': round(dt_ev, 1),
        'gbs_profile': gbs_profile,
        'sample_wall_s': round(dt_warm + dt_post, 1),
        'n_call': int(tt.n_call) + (n_call32 if mixed_warmup else 0),
    }
    if mixed_warmup:
        rec['mixed_warmup'] = True
    return rec


def run_donut():
    from examples import donut_recipe
    t0 = time.time()
    res = donut_recipe.main()
    r = np.linalg.norm(res.samples, axis=-1)
    w = res.weights_trunc
    return {
        'config': 'donut_recipe', 'dtype': 'float64',
        'E_r': round(float(np.sum(r * w) / np.sum(w)), 3),
        'n_call': int(res.n_call), 'ref_n_call': 330,
        'wall_s': round(time.time() - t0, 1),
    }


def run_des():
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__),
                                      'poly_fit_bench.py')],
        capture_output=True, text=True, check=True)
    lines = [l for l in out.stdout.splitlines() if l.startswith('{')]
    return {'config': 'des_poly_surrogate',
            'results': [json.loads(l) for l in lines]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--configs', default='')
    ap.add_argument('--n-chain', type=int, default=64)
    ap.add_argument('--n-chain-fill', type=int, default=1024)
    ap.add_argument('--n-iter', type=int, default=2500)
    ap.add_argument('--n-warmup', type=int, default=1000)
    args = ap.parse_args()

    import jax
    from _common import device_report, require_gpu, setup_cache
    setup_cache()
    jax.config.update('jax_enable_x64', True)
    require_gpu()
    device = device_report()

    import traceback
    for name in [c for c in args.configs.split(',') if c]:
        try:
            if name == 'donut':
                rec = run_donut()
            elif name == 'des':
                rec = run_des()
            elif name.endswith('@fill'):
                # fill tier: float32 sampling at n-chain-fill
                rec = run_gbs_config(name[:-5], args.n_chain_fill,
                                     args.n_iter, args.n_warmup,
                                     dtype='float32')
            elif name.endswith('@mixed'):
                # f32 warmup + warm-started f64 posterior
                rec = run_gbs_config(name[:-6], args.n_chain, args.n_iter,
                                     args.n_warmup, mixed_warmup=True)
            else:
                rec = run_gbs_config(name, args.n_chain, args.n_iter,
                                     args.n_warmup)
        except Exception:
            traceback.print_exc()
            print(f'config {name} FAILED; continuing.', flush=True)
            continue
        rec['device'] = device
        with open(RESULTS_PATH, 'a') as f:
            f.write(json.dumps(rec) + '\n')
        print(json.dumps(rec), flush=True)


if __name__ == '__main__':
    main()
