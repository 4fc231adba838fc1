"""Do the sampler extensions earn their keep?

Head-to-head ESS/sec of the two extensions against the batched-NUTS
default, on the geometry each one targets:

1. ChEES-HMC vs NUTS — 64-d ill-conditioned Gaussian (condition number
   1e4): ChEES runs lockstep jittered-length trajectories with no tree
   bookkeeping, so when NUTS trees are deep the per-iteration overhead
   difference shows up directly in ESS/sec.
2. Pooled-metric NUTS vs per-chain NUTS at a SHORT warmup (150
   iterations) — the pooled Welford sees n_chain samples per iteration,
   so the mass matrix converges ~n_chain times faster in iterations;
   per-chain adaptation is still raw when the warmup budget is tight.

Each case prints one JSON line; float32, 1024 chains, one GPU.
"""

import json
import os
import time

import numpy as np


def main():
    import jax.numpy as jnp
    import bayesfast_jax as bf
    from bayesfast_jax.utils.acor import effective_sample_size

    C = int(os.environ.get('BENCH_N_CHAIN', 1024))
    D = 64
    scales = np.logspace(0, 2, D)  # condition number 1e4
    s2 = jnp.asarray(scales ** 2, jnp.float32)

    def logp(x):
        return -0.5 * jnp.sum(x * x / s2)

    def run(sampler, n_warmup, n_post, **trace_kw):
        bf.utils.set_generator(7)
        den = bf.DensityLite(logp=logp, input_size=D)
        trace_kw.update(n_chain=C, n_iter=n_warmup + n_post,
                        n_warmup=n_warmup)
        tt = bf.sample(den, trace_kw, sampler=sampler, n_run=2,
                       verbose=False, n_update=2)
        tt = bf.sample(den, tt, n_run=n_warmup - 2, verbose=False,
                       n_update=n_warmup)
        t0 = time.time()
        tt = bf.sample(den, tt, n_run=n_post, verbose=False, n_update=n_post)
        dt = time.time() - t0
        s = tt.get(flatten=False)
        ess = float(np.sum(effective_sample_size(s)) / D)
        # worst-dimension ESS is what converges slowest on anisotropic
        # targets
        ess_min = float(np.min(effective_sample_size(s)))
        return {'ess_per_sec': round(ess / dt, 1),
                'ess_min_per_sec': round(ess_min / dt, 1),
                'post_wall_s': round(dt, 1),
                'n_call': int(tt.n_call)}

    out = {'n_chain': C, 'dim': D, 'condition': 1e4, 'cases': {}}

    out['cases']['nuts'] = run('NUTS', 500, 500)
    out['cases']['chees'] = run('CHEES', 500, 500)
    out['cases']['nuts_short_warmup'] = run('NUTS', 150, 500)
    out['cases']['pooled_short_warmup'] = run('NUTS', 150, 500,
                                              pooled_metric=True)
    # ultra-short warmup: per-chain Welford cannot even fill its first
    # adaptation window (60 iters), the pooled metric sees n_chain samples
    # per iteration
    out['cases']['nuts_w50'] = run('NUTS', 50, 500)
    out['cases']['pooled_w50'] = run('NUTS', 50, 500, pooled_metric=True)
    print(json.dumps(out))
    if os.environ.get('SKIP_CAUCHY') != '1':
        print(json.dumps(run_cauchy_tempered()))


def run_cauchy_tempered():
    """TNUTS vs NUTS on the cauchy-48 anchor — the bimodal heavy-tailed
    geometry continuous tempering exists for (reference
    ``samplers/hmc_utils/integration.py:98-222``): the tempered Hamiltonian
    interpolates the target with a unimodal Gaussian base, so chains cross
    between the +-5 modes through the base instead of tunneling.

    Reports per sampler: ESS/sec (Kish-weighted for TNUTS), the
    cross-mode mixing rate (per-chain fraction of post-warmup sign flips of
    the first coordinate), and GBS logz on the post-warmup samples
    (systematically resampled by the tempering weights for TNUTS) against
    the reference fiducial -254.627.
    """
    import jax.numpy as jnp
    import bayesfast_jax as bf
    from bayesfast_jax.utils.acor import effective_sample_size

    C = int(os.environ.get('BENCH_N_CHAIN', 1024))
    D, a = 48, 5.
    bound = np.stack((np.full(D, -100.), np.full(D, 100.))).T
    const = float(D * np.log(200.))
    fiducial = -254.627

    def logp(x):
        _a = 1 / ((x + a) ** 2 + 1)
        _b = 1 / ((x - a) ** 2 + 1)
        return (jnp.sum(jnp.log(_a + _b)) + D * jnp.log(0.5 / jnp.pi)
                - const)

    # unimodal base bridging the two modes; logxi offsets the target/base
    # mass imbalance (a rough pilot logz estimate; here the fiducial class)
    s_base = 8.0

    def logp_base(x):
        return (-0.5 * jnp.sum(x ** 2) / s_base ** 2
                - D * np.log(np.sqrt(2 * np.pi) * s_base) - const)

    n_warmup = int(os.environ.get('CAUCHY_N_WARMUP', 500))
    n_post = int(os.environ.get('CAUCHY_N_POST', 500))

    def run_one(sampler):
        bf.utils.set_generator(48)
        den = bf.DensityLite(logp=logp, input_size=D, input_scales=bound,
                             hard_bounds=True)
        kw = {'n_chain': C, 'n_iter': n_warmup + n_post,
              'n_warmup': n_warmup}
        if sampler == 'TNUTS':
            base = bf.DensityLite(logp=logp_base, input_size=D,
                                  input_scales=bound, hard_bounds=True)
            kw.update(density_base=base, logxi=-255.0)
        tt = bf.sample(den, kw, sampler=sampler, n_run=2, verbose=False,
                       n_update=2)
        tt = bf.sample(den, tt, n_run=n_warmup - 2, verbose=False,
                       n_update=50)
        t0 = time.time()
        tt = bf.sample(den, tt, n_run=n_post, verbose=False, n_update=50)
        dt = time.time() - t0

        s = tt.get(flatten=False)                  # (chain, iter, dim)
        ess = float(np.sum(effective_sample_size(s)) / D)
        flat = s.reshape(-1, D)
        if sampler == 'TNUTS':
            w = tt.trace.weights[:, n_warmup:].reshape(-1)
            kish = float(np.sum(w) ** 2 / (np.sum(w ** 2) * w.size))
            ess *= kish
            # systematic resampling to an unweighted set for GBS
            rng = np.random.default_rng(9)
            pos = (rng.uniform() + np.arange(flat.shape[0])) / flat.shape[0]
            idx = np.searchsorted(np.cumsum(w / np.sum(w)), pos)
            flat_gbs = flat[np.clip(idx, 0, flat.shape[0] - 1)]
        else:
            kish = 1.0
            flat_gbs = flat
        # cross-mode mixing: mean per-chain rate of first-coord sign flips
        sign = np.sign(s[..., 0])
        flips = float(np.mean(np.abs(np.diff(sign, axis=1)) > 0))
        x_gbs = flat_gbs.reshape(2, -1, D)  # 2 pseudo-chains for the split
        logz, logz_err = bf.GBS(n_q=50_000)(x_gbs, den.logp)[:2]
        return {'ess_per_sec': round(ess / dt, 1),
                'kish_factor': round(kish, 3),
                'mode_flip_rate': round(flips, 4),
                'logz': round(float(logz), 3),
                'logz_err': round(float(logz_err), 3),
                'sigma_off_fiducial': round(
                    abs(float(logz) - fiducial) / float(logz_err), 1),
                'post_wall_s': round(dt, 1)}

    return {'case': 'cauchy48_tempering', 'n_chain': C, 'dim': D,
            'fiducial': fiducial,
            'nuts': run_one('NUTS'), 'tnuts': run_one('TNUTS')}


if __name__ == '__main__':
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _common import device_report, require_gpu, setup_cache
    setup_cache()
    require_gpu()
    print(json.dumps({'device': device_report()}))
    main()
