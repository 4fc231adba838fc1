"""Banana-32 log-evidence decomposition study.

Round-1 flagship validation left a ~4-sigma gap between our GBS logz and the
fiducial value quoted in the reference notebook (``examples/banana-gbs.ipynb``
cell 7: "fiducial value: logz = -127.364"; the reference's own published run
is -127.276 +- 0.053, itself 1.7 sigma high). This script decomposes the gap
into its possible sources with three independent legs:

1. ``fiducial`` — the banana density factorizes into 16 exactly-normalized
   2-d pairs, so the only unknown in logz is the mass lost to the rotated
   [-15, 15]^32 box truncation. We measure that acceptance alpha by direct
   Monte Carlo from the exact banana distribution (x ~ N(1, 1/sqrt(2)),
   y | x ~ N(x^2, sqrt(Q/2))), giving an independent high-precision fiducial:
   logz_true = 16 log(pi sqrt(Q)) - 32 log(30) + log(alpha).

2. ``iid`` — run the full evidence stack (SIT fit + flow draws + bridge) on
   *perfect i.i.d. samples* of the target, obtained by rejection against the
   box. Any systematic offset that survives here belongs to the evidence
   stack (SIT sample/logq consistency, bridge numerics); if the offset
   vanishes, it belongs to the sampler leg.

3. ``mcmc`` — repeat the reference configuration (8 chains x 2500 iters,
   1000 warmup, float64) over many generator seeds, recording GBS/GIS/GHM
   estimates, reported errors, split-R-hat and autocorrelation diagnostics.
   Cross-seed scatter vs the mean reported error separates error-bar
   optimism from genuine bias.

Each leg prints one JSON line; ``examples/banana_study_results.json`` in the
repo collects the committed study.

Usage:
    python examples/banana_study.py fiducial [--n-draw 2e8]
    python examples/banana_study.py iid [--seed 0] [--n-per-chain 1500]
    python examples/banana_study.py mcmc --seeds 101,102 [--n-chain 8]
"""

import argparse
import json
import sys
import time

import numpy as np
import jax
jax.config.update('jax_enable_x64', True)
import jax.numpy as jnp
from scipy.stats import special_ortho_group

D, Q = 32, 0.01
HALF = 15.0
LOGZ_UNTRUNCATED = 16 * np.log(np.pi * np.sqrt(Q)) - D * np.log(2 * HALF)


def rotation():
    return np.asarray(special_ortho_group.rvs(D, random_state=0))


def make_density(A):
    import bayesfast_jax as bf
    bound = np.stack((np.full(D, -HALF), np.full(D, HALF))).T
    const = float(D * np.log(2 * HALF))
    A_j = jnp.asarray(A)

    def logp(x):
        z = x @ A_j.T
        return (-jnp.sum((z[::2] ** 2 - z[1::2]) ** 2 / Q
                         + (z[::2] - 1) ** 2) - const)

    return bf.DensityLite(logp=logp, input_size=D, input_scales=bound,
                          hard_bounds=True)


def draw_banana_exact(rng, n):
    """n i.i.d. draws from the *untruncated* banana in pair coordinates z."""
    z = np.empty((n, D))
    x = rng.normal(1.0, np.sqrt(0.5), size=(n, D // 2))
    y = rng.normal(x ** 2, np.sqrt(Q / 2))
    z[:, ::2] = x
    z[:, 1::2] = y
    return z


def leg_fiducial(args):
    """Measure the box-truncation acceptance alpha by direct MC."""
    rng = np.random.default_rng(20260819)
    A = rotation()
    n_total = 0
    n_acc = 0
    batch = 4_000_000
    target = int(float(args.n_draw))
    t0 = time.time()
    while n_total < target:
        z = draw_banana_exact(rng, batch)
        xs = z @ A
        n_acc += int(np.sum(np.all(np.abs(xs) <= HALF, axis=1)))
        n_total += batch
    alpha = n_acc / n_total
    # binomial error propagated through log
    alpha_err = np.sqrt(alpha * (1 - alpha) / n_total)
    logz_true = LOGZ_UNTRUNCATED + np.log(alpha)
    out = {
        'leg': 'fiducial', 'n_draw': n_total, 'alpha': alpha,
        'alpha_err': alpha_err, 'log_alpha': float(np.log(alpha)),
        'logz_untruncated': LOGZ_UNTRUNCATED,
        'logz_true': float(logz_true),
        'logz_true_err': float(alpha_err / alpha),
        'notebook_fiducial': -127.364,
        'wall_s': round(time.time() - t0, 1),
    }
    print(json.dumps(out))
    return out


def draw_iid_truncated(rng, n):
    """n i.i.d. draws from the truncated target, in original coordinates."""
    A = rotation()
    out = np.empty((0, D))
    while out.shape[0] < n:
        z = draw_banana_exact(rng, max(2 * n, 100_000))
        xs = z @ A
        keep = np.all(np.abs(xs) <= HALF, axis=1)
        out = np.concatenate([out, xs[keep]])
    return out[:n]


def _evidence_suite(x_p, logp_fn, logp_p, n_q, sit_seed,
                    estimators=('gbs', 'gis', 'ghm')):
    """Run the selected estimators on one (chains, iters, dim) sample
    block. Each fits its own SIT flow (~minutes at banana scale), so
    per-seed MCMC runs default to GBS only."""
    import bayesfast_jax as bf
    res = {}
    if 'gbs' in estimators:
        est = bf.evidence.GBS(n_q=n_q, sit={'random_generator': sit_seed})
        logz, err = est.run(x_p, logp_fn, logp_p)
        res['logz_gbs'] = float(logz)
        res['err_gbs'] = float(err)
    if 'gis' in estimators:
        est = bf.evidence.GIS(n_q=n_q, sit={'random_generator': sit_seed})
        logz, err = est.run(x_p, logp_fn, logp_p)
        res['logz_gis'] = float(logz)
        res['err_gis'] = float(err)
    if 'ghm' in estimators:
        ghm = bf.evidence.GHM(sit={'random_generator': sit_seed})
        logz, err = ghm.run(x_p, logp_fn, logp_p)
        res['logz_ghm'] = float(logz)
        res['err_ghm'] = float(err)
    return res


def leg_iid(args):
    """Evidence stack on perfect i.i.d. truncated-banana samples."""
    rng = np.random.default_rng(args.seed + 555)
    A = rotation()
    den = make_density(A)
    n_chain, n_per = args.n_chain, args.n_per_chain
    t0 = time.time()
    x = draw_iid_truncated(rng, n_chain * n_per)
    x_p = x.reshape(n_chain, n_per, D)
    logp_p = den.logp(x_p)
    res = _evidence_suite(x_p, den.logp, logp_p, args.n_q, args.seed + 777)
    out = {
        'leg': 'iid', 'seed': args.seed, 'n_chain': n_chain,
        'n_per_chain': n_per, 'n_q': args.n_q,
        **res, 'wall_s': round(time.time() - t0, 1),
    }
    print(json.dumps(out))
    return out


def leg_mcmc(args):
    """Seeded reference-configuration MCMC + evidence runs (one JSON line
    per seed; all seeds share one process so compiles amortize)."""
    import bayesfast_jax as bf
    from bayesfast_jax.utils.acor import integrated_time, rhat

    A = rotation()
    den = make_density(A)
    estimators = tuple(args.estimators.split(','))
    outs = []
    for seed in [int(s) for s in args.seeds.split(',')]:
        bf.utils.set_generator(seed)
        t0 = time.time()
        trace = bf.NTrace(n_chain=args.n_chain, n_iter=args.n_iter,
                          n_warmup=args.n_warmup)
        tt = bf.sample(den, trace, verbose=False)
        t_sample = time.time() - t0

        x_p = tt.get(flatten=False)        # (chain, iter, dim), original
        logp_p = tt.get(flatten=False, return_type='logp')
        n_q = args.n_q or int(0.05 * tt.n_call)

        t1 = time.time()
        res = _evidence_suite(tt, den.logp, logp_p, n_q, seed + 777,
                              estimators)
        t_evidence = time.time() - t1

        tau = float(np.mean(integrated_time(x_p, quiet=True)))
        r = float(np.max(rhat(x_p)))
        mean_logp = float(np.mean(logp_p))
        out = {
            'leg': 'mcmc', 'seed': seed, 'n_chain': args.n_chain,
            'n_iter': args.n_iter, 'n_warmup': args.n_warmup,
            'n_call': int(tt.n_call), 'n_q': n_q,
            **res,
            'tau_mean': tau, 'rhat_max': r, 'mean_logp': mean_logp,
            'wall_sample_s': round(t_sample, 1),
            'wall_evidence_s': round(t_evidence, 1),
        }
        print(json.dumps(out), flush=True)
        outs.append(out)
    return outs


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest='leg', required=True)

    p = sub.add_parser('fiducial')
    p.add_argument('--n-draw', default='2e8')

    p = sub.add_parser('iid')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--n-chain', type=int, default=8)
    p.add_argument('--n-per-chain', type=int, default=1500)
    p.add_argument('--n-q', type=int, default=100_000)

    p = sub.add_parser('mcmc')
    p.add_argument('--seeds', required=True,
                   help='comma-separated generator seeds')
    p.add_argument('--n-chain', type=int, default=8)
    p.add_argument('--n-iter', type=int, default=2500)
    p.add_argument('--n-warmup', type=int, default=1000)
    p.add_argument('--n-q', type=int, default=None)
    p.add_argument('--estimators', default='gbs')

    args = ap.parse_args()
    {'fiducial': leg_fiducial, 'iid': leg_iid, 'mcmc': leg_mcmc}[args.leg](
        args)


if __name__ == '__main__':
    main()
