"""Smoke run of the sampler, evidence and Recipe paths on one GPU.

    python chip_smoke.py                 # phases (a)-(e) on one card
    python chip_smoke.py --four-cards    # phase (f) only, on four cards

Phases, in one process, stopping at the first failure:

(a) device: JAX's first device must be a GPU (no CPU fallback);
(b) sampling: bench.py's banana-32 (D=32, Q=0.01, hard bounds, SO(32)
    rotation) with 1024 float32 chains through ``bf.sample``; gates: finite
    samples, split-R-hat < 1.1 on >= 95% of dims, no kernel-selection
    warning;
(c) evidence: GBS on the phase-(b) trace vs the banana fiducial, and a
    float64 GBS of a 16-d standard normal vs its analytic logz;
(d) Recipe: examples/donut_recipe.py's configuration through ``bf.Recipe``;
(e) parity of the device programs with the same code on the CPU backend
    of this process: banana-32 logp/grad, one NUTS transition, and the
    batched KDE cdf against the native host library;
(f) four cards (``--four-cards``): banana-32 with chains sharded over a
    1-d mesh vs one card, and GBS on the mesh vs without it.

Every phase prints its numbers beside the card's name and power limit. The
last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import json
import sys
import time
import warnings

import numpy as np

BANANA_FIDUCIAL = -127.364  # examples/banana_gbs.py, BASELINE.md


def _log(msg):
    print(msg, flush=True)


class _Smoke:
    def __init__(self, card):
        self.card = card

    def report(self, phase, **numbers):
        body = ', '.join(f'{k}={v}' for k, v in numbers.items())
        _log(f'[{phase}] [{self.card}] {body}')

    @staticmethod
    def gate(ok, what):
        if not ok:
            raise AssertionError(f'gate failed: {what}')


def _cpu():
    import jax
    return jax.devices('cpu')[0]


def phase_sampling(sm, n_chain, n_warmup, n_post, n_update):
    """(b) banana-32 through bf.sample in float32; returns the trace."""
    import jax
    import jax.numpy as jnp
    import bayesfast_jax as bf
    from bayesfast_jax.utils.acor import rhat
    from bench import banana_density

    bf.utils.set_generator(32)
    den = banana_density(jnp.float32)
    trace = bf.NTrace(n_chain=n_chain, n_iter=n_warmup + n_post,
                      n_warmup=n_warmup)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        t0 = time.perf_counter()
        # first chunk: compile + start descent + step probe (set-up)
        tt = bf.sample(den, trace, n_run=n_update, verbose=False,
                       n_update=n_update)
        t_setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        tt = bf.sample(den, tt, n_run=n_warmup - n_update, verbose=False,
                       n_update=n_update)
        t_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        tt = bf.sample(den, tt, n_run=n_post, verbose=False,
                       n_update=n_update)
        t_post = time.perf_counter() - t0
    kernel_warnings = [str(w.message) for w in caught
                       if 'kernel' in str(w.message).lower()]
    other = len(caught) - len(kernel_warnings)

    driver = tt.trace._driver_cache[1]
    flags = jnp.zeros(n_update, bool)
    mem = driver._compiled.lower(tt.trace._carry, flags, ()).compile(
        ).memory_analysis()
    sm.report('b memory_analysis', chunk_len=n_update,
              argument_bytes=mem.argument_size_in_bytes,
              output_bytes=mem.output_size_in_bytes,
              temp_bytes=mem.temp_size_in_bytes,
              generated_code_bytes=mem.generated_code_size_in_bytes)

    st = tt.trace._stats_arrays
    size = st['tree_size'][:, n_warmup:]
    # the tree loop runs every chain in lockstep until the last one is
    # done, so its iteration count per transition is the largest tree
    leaf_iters = float(np.sum(size.max(axis=0)))
    samples = tt.get(flatten=False)                  # (chain, iter, dim)
    r = rhat(samples)
    sm.report('b sampling', n_chain=n_chain, dtype='float32',
              n_warmup=n_warmup, n_post=n_post,
              setup_s=t_setup,
              warmup_it_s=n_chain * (n_warmup - n_update) / t_warm,
              post_it_s=n_chain * n_post / t_post,
              mean_tree_size_post=float(size.mean()),
              mean_tree_depth_post=float(st['tree_depth'][:, n_warmup:]
                                         .mean()),
              us_per_leaf_iteration=t_post / leaf_iters * 1e6,
              chain_leapfrogs_per_s=float(size.sum()) / t_post,
              rhat_max=float(r.max()),
              rhat_frac_below_1_1=float(np.mean(r < 1.1)),
              other_warnings=other, n_call=int(tt.n_call))
    sm.gate(np.all(np.isfinite(samples)), 'all samples finite')
    sm.gate(np.mean(r < 1.1) >= 0.95, 'R-hat < 1.1 on >= 95% of dims')
    sm.gate(not kernel_warnings,
            f'no kernel-selection warning ({kernel_warnings[:1]})')
    return den, tt


def float32_logp_grad(q):
    """Banana logp/grad in float32 at ``q`` (transformed space): on the card
    at the session's precision and at 'default' (TF32-eligible) precision,
    and on the CPU backend. Call it before float64 is switched on: with
    x64 on, the density's float64 transform constants would promote a
    float32 input."""
    import jax
    import jax.numpy as jnp
    from bench import banana_density

    def run(device, prec):
        with jax.default_device(device), jax.default_matmul_precision(prec):
            den = banana_density(jnp.float32)
            lpg = den.device_logp_and_grad(original_space=False)
            lp, g = jax.jit(jax.vmap(lambda x: lpg((), x)))(
                jax.device_put(jnp.asarray(q, jnp.float32), device))
        return np.asarray(lp, np.float64), np.asarray(g, np.float64)

    return {'card': run(jax.devices()[0], 'highest'),
            'card_default': run(jax.devices()[0], 'default'),
            'cpu': run(_cpu(), 'highest')}


def phase_gbs_banana(sm, den, tt):
    """(c) GBS on the phase-(b) trace vs the banana fiducial."""
    import bayesfast_jax as bf
    bf.utils.set_generator(7)
    t0 = time.perf_counter()
    logz, err = bf.GBS(f_call=0.05, n_q_max=100_000)(tt, den.logp)[:2]
    dt = time.perf_counter() - t0
    delta = float(logz - BANANA_FIDUCIAL)
    sm.report('c gbs banana32 float32', logz=float(logz), err=float(err),
              fiducial=BANANA_FIDUCIAL, delta=delta, wall_s=dt)
    sm.gate(abs(delta) <= max(4 * err, 0.1),
            f'|logz - fiducial| = {abs(delta)} <= max(4 sigma, 0.1)')


def phase_gbs_normal64(sm, n_chain=256, n_iter=1000, n_warmup=500):
    """(c) float64 GBS of a 16-d standard normal vs 8 log(2 pi)."""
    import jax.numpy as jnp
    import bayesfast_jax as bf
    D = 16
    den = bf.DensityLite(logp=lambda x: -0.5 * jnp.sum(x ** 2),
                         input_size=D, vectorized=True)
    bf.utils.set_generator(16)
    t0 = time.perf_counter()
    tt = bf.sample(den, {'n_chain': n_chain, 'n_iter': n_iter,
                         'n_warmup': n_warmup}, verbose=False,
                   n_update=n_iter // 4)
    logz, err = bf.GBS(f_call=0.05, n_q_max=100_000)(tt, den.logp)[:2]
    dt = time.perf_counter() - t0
    truth = 0.5 * D * np.log(2 * np.pi)
    delta = float(logz - truth)
    sm.report('c gbs normal16 float64', n_chain=n_chain, logz=float(logz),
              err=float(err), truth=truth, delta=delta, wall_s=dt)
    sm.gate(abs(delta) <= 4 * err, f'|logz - truth| = {abs(delta)} <= '
            f'4 sigma = {4 * err}')


def phase_recipe(sm):
    """(d) the donut Recipe (examples/donut_recipe.py)."""
    from examples import donut_recipe
    t0 = time.perf_counter()
    res = donut_recipe.main()
    dt = time.perf_counter() - t0
    r = np.linalg.norm(res.samples, axis=-1)
    w = res.weights_trunc
    e_r = float(np.sum(r * w) / np.sum(w))
    sm.report('d recipe donut', E_r=e_r, n_call=int(res.n_call), wall_s=dt)
    sm.gate(abs(e_r - 5.0) <= 0.5, f'E[r] = {e_r} within 0.5 of 5')


def rel_errors(lp, g, lp_ref, g_ref):
    """Largest per-chain relative error of logp and of the gradient norm."""
    e_lp = np.max(np.abs(lp - lp_ref) / np.maximum(np.abs(lp_ref), 1e-300))
    e_g = np.max(np.linalg.norm(g - g_ref, axis=-1)
                 / np.maximum(np.linalg.norm(g_ref, axis=-1), 1e-300))
    return float(e_lp), float(e_g)


def phase_parity_logp(sm, q, f32):
    """(e) banana-32 logp/grad: card float32 vs CPU float64.

    float32 itself cannot meet rtol 1e-5 at every point: the banana term
    ``(z^2 - z_next)^2 / Q`` cancels, so a float32 gradient carries a
    relative error of its own, up to a few 1e-5 at the worst of 1024
    chains. The CPU backend's float32 evaluation of the same program
    measures that error; the card must agree with the float64 reference
    within rtol 1e-5 or within twice the CPU's own float32 error,
    whichever is larger."""
    import jax
    import jax.numpy as jnp
    from bench import banana_density
    with jax.default_device(_cpu()):
        den = banana_density(jnp.float64)
        lpg = den.device_logp_and_grad(original_space=False)
        lp, g = jax.jit(jax.vmap(lambda x: lpg((), x)))(
            jnp.asarray(q, jnp.float64))
    ref = (np.asarray(lp), np.asarray(g))
    e_card = rel_errors(*f32['card'], *ref)
    e_cpu = rel_errors(*f32['cpu'], *ref)
    e_default = rel_errors(*f32['card_default'], *ref)
    e_backend = rel_errors(*f32['card'], *f32['cpu'])
    bound = max(1e-5, 2 * max(e_cpu))
    sm.report('e parity logp_and_grad banana32', shape=tuple(q.shape),
              card='float32 highest', reference='cpu float64',
              rel_err_logp=e_card[0], rel_err_grad=e_card[1],
              cpu_float32_rel_err_logp=e_cpu[0],
              cpu_float32_rel_err_grad=e_cpu[1], bound=bound,
              card_vs_cpu_float32_rel_err_logp=e_backend[0],
              card_vs_cpu_float32_rel_err_grad=e_backend[1],
              default_precision_rel_err_logp=e_default[0],
              default_precision_rel_err_grad=e_default[1])
    sm.gate(max(e_card) <= bound,
            f'card vs float64 relative error {e_card} <= {bound}')


def phase_parity_transition(sm, q, var, eps, max_treedepth=10):
    """(e) one float64 NUTS transition, card vs CPU, same key and start."""
    import jax
    import jax.numpy as jnp
    from bench import banana_density
    from bayesfast_jax.samplers.metrics import init_diag_metric
    from bayesfast_jax.samplers.nuts import nuts_transition_batched

    def run(device):
        with jax.default_device(device):
            den = banana_density(jnp.float64)
            lpg = den.device_logp_and_grad(original_space=False)
            lpg_b = jax.vmap(lambda x: lpg((), x))
            qd = jax.device_put(jnp.asarray(q, jnp.float64), device)
            metric = jax.vmap(init_diag_metric)(
                qd, jax.device_put(jnp.asarray(var, jnp.float64), device))
            step = jax.jit(lambda k, x, m, e: nuts_transition_batched(
                k, x, m, e, lpg_b, max_treedepth, 1000.0))
            key = jax.device_put(jax.random.PRNGKey(2024), device)
            q_new, st = step(key, qd, metric, jax.device_put(
                jnp.asarray(eps, jnp.float64), device))
            return np.asarray(q_new), np.asarray(st.tree_depth)

    import jax as _jax
    t0 = time.perf_counter()
    q_dev, d_dev = run(_jax.devices()[0])
    q_cpu, d_cpu = run(_cpu())
    dt = time.perf_counter() - t0
    same_depth = d_dev == d_cpu
    close = np.max(np.abs(q_dev - q_cpu), axis=-1) <= 1e-6
    frac = float(np.mean(same_depth & close))
    sm.report('e parity nuts_transition_batched', n_chain=q.shape[0],
              dim=q.shape[1], dtype='float64',
              frac_same_depth=float(np.mean(same_depth)),
              frac_dq_within_1e_6=float(np.mean(close)), frac_both=frac,
              mean_depth=float(d_dev.mean()), wall_s=dt)
    sm.gate(frac >= 0.99, f'{frac} of chains agree (>= 0.99)')


def phase_parity_kde(sm, n_col=32, n_data=65536, n_query=512):
    """(e) kde_cdf_batch (card, float32) vs the native host library."""
    import jax.numpy as jnp
    from bayesfast_jax.native import bindings
    from bayesfast_jax.ops.kde import kde_cdf_batch
    rng = np.random.default_rng(3)
    data = rng.normal(size=(n_col, n_data)) * rng.uniform(0.5, 2, (n_col, 1))
    w = rng.uniform(0.5, 1.5, n_data)
    w /= w.sum()
    h = 1.06 * data.std(axis=1) * n_data ** -0.2
    x = np.sort(rng.normal(size=(n_col, n_query)) * 2.5, axis=1)
    t0 = time.perf_counter()
    out = np.asarray(kde_cdf_batch(
        jnp.asarray(x, jnp.float32), jnp.asarray(data, jnp.float32),
        jnp.asarray(w, jnp.float32), jnp.asarray(h, jnp.float32)),
        np.float64)
    dt = time.perf_counter() - t0
    ref = np.stack([bindings.kde_cdf(data[d], w, h[d], x[d])
                    for d in range(n_col)])
    err = float(np.max(np.abs(out - ref)))
    sm.report('e parity kde_cdf_batch', columns=n_col, n_data=n_data,
              n_query=n_query, card='float32',
              reference='native float64', max_abs_err=err, atol=1e-5,
              wall_s_incl_compile=dt)
    sm.gate(err <= 1e-5, f'KDE cdf max abs error {err} <= 1e-5')


def phase_four_cards(sm, n_chain=4096):
    """(f) chains sharded over four cards vs one card; GBS mesh vs none."""
    import jax
    import jax.numpy as jnp
    import bayesfast_jax as bf
    from bayesfast_jax.parallel import make_mesh, set_mesh
    from bench import banana_density

    devs = jax.devices()
    sm.gate(len(devs) >= 4, f'four cards visible (found {len(devs)})')
    mesh = make_mesh(devs[:4])
    jax.config.update('jax_enable_x64', True)
    den = banana_density(jnp.float64)
    cfg = {'n_chain': n_chain, 'n_iter': 5, 'n_warmup': 3}
    # 3 warmup iterations cannot meet the acceptance target; the per-chain
    # warnings about it say nothing here
    with warnings.catch_warnings():
        warnings.filterwarnings('ignore', 'for chain #')
        bf.utils.set_generator(41)
        t0 = time.perf_counter()
        tt_m = bf.sample(den, dict(cfg), verbose=False, mesh=mesh)
        t_mesh = time.perf_counter() - t0
        in_use = [(d.memory_stats() or {}).get('bytes_in_use')
                  for d in devs[:4]]
        shards = len(tt_m.trace._carry.q.sharding.device_set)
        bf.utils.set_generator(41)
        t0 = time.perf_counter()
        tt_s = bf.sample(den, dict(cfg), verbose=False, mesh=None)
        t_single = time.perf_counter() - t0
    # a chain-sharded program is not bitwise the unsharded one on the GPU:
    # XLA fuses (and contracts into FMAs) per shape, and cuBLAS may pick
    # another matmul kernel at 1024 rows per card than at 4096. A NUTS
    # trajectory amplifies such last-bit differences, so a few chains part
    # ways within 5 iterations; the rest must agree to 1e-5
    dq = np.abs(tt_m.samples - tt_s.samples).max(axis=-1)  # (chain, iter)
    off = dq > 1e-5
    frac = float(1 - off.any(axis=1).mean())
    same_depth = np.mean(tt_m.trace._stats_arrays['tree_depth']
                         == tt_s.trace._stats_arrays['tree_depth'])
    sm.report('f mesh sampling banana32', n_chain=n_chain, n_iter=5,
              dtype='float64', carry_shards=shards,
              chains_off_by_iteration=off.sum(axis=0).tolist(),
              frac_chains_within_1e_5=frac,
              frac_same_depth=float(same_depth),
              max_abs_diff=float(dq.max()), bytes_in_use_per_card=in_use,
              wall_mesh_s_incl_compile=t_mesh,
              wall_single_s_incl_compile=t_single)
    sm.gate(shards == 4, 'carry sharded over 4 cards')
    sm.gate(frac >= 0.99, f'{frac} of chains within 1e-5 (>= 0.99)')

    # evidence on the mesh: proposal logp batches and the KDE-cdf data
    # axis (a psum over the cards) shard; the same trace without a mesh
    D = 16
    den16 = bf.DensityLite(logp=lambda x: -0.5 * jnp.sum(x ** 2),
                           input_size=D, vectorized=True)
    bf.utils.set_generator(16)
    tt = bf.sample(den16, {'n_chain': 1024, 'n_iter': 300, 'n_warmup': 150},
                   verbose=False, n_update=150)

    def gbs():
        bf.utils.set_generator(7)
        return bf.GBS(n_q=65536, sit={'random_generator': 3})(
            tt, den16.logp)[:2]

    set_mesh(mesh)
    try:
        t0 = time.perf_counter()
        lz_m, err_m = gbs()
        t_m = time.perf_counter() - t0
    finally:
        set_mesh(None)
    t0 = time.perf_counter()
    lz_s, err_s = gbs()
    t_s = time.perf_counter() - t0
    delta = float(abs(lz_m - lz_s))
    sm.report('f gbs mesh vs single normal16', logz_mesh=float(lz_m),
              logz_single=float(lz_s), err=float(err_s), abs_diff=delta,
              limit=1e-3, wall_mesh_s=t_m, wall_single_s=t_s)
    sm.gate(delta < 1e-3, f'|logz mesh - single| = {delta} < 1e-3')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--four-cards', action='store_true',
                    help='run only the four-card mesh phase (f)')
    args = ap.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        sys.exit(f'no GPU: jax.devices()[0] is {dev.platform!r}; '
                 'this smoke run needs the card.')
    from benchmarks._common import device_report, setup_cache
    setup_cache()
    rep = device_report()
    _log(f"device: platform={rep['platform']} kind={rep['kind']} "
         f"count={rep['count']} jax={rep['jax']} "
         f"XLA_FLAGS={rep['xla_flags']!r} "
         f"compile_cache={rep['compile_cache']}")
    _log(rep['nvidia_smi'])
    from bayesfast_jax.native import bindings
    _log(f'native host library available: {bindings.available()}')
    sm = _Smoke(rep['nvidia_smi'].splitlines()[0])

    t_start = time.perf_counter()
    if args.four_cards:
        phase_four_cards(sm)
    else:
        # warmup and post iterations cut from the reference's 1000 + 1500
        # to fit the run limit; one chunk length for every call
        den, tt = phase_sampling(sm, n_chain=1024, n_warmup=200, n_post=100,
                                 n_update=50)
        q = np.asarray(tt.trace._carry.q, np.float64)
        var = np.asarray(tt.trace._carry.metric.var, np.float64)
        eps = np.exp(np.asarray(tt.trace._carry.step.log_bar, np.float64))
        f32 = float32_logp_grad(q)
        phase_gbs_banana(sm, den, tt)
        jax.config.update('jax_enable_x64', True)
        phase_gbs_normal64(sm)
        phase_recipe(sm)
        phase_parity_logp(sm, q, f32)
        phase_parity_transition(sm, q, var, eps)
        phase_parity_kde(sm)
    _log(f'total_s={time.perf_counter() - t_start:.1f}')
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(jax.devices())}}), flush=True)


if __name__ == '__main__':
    main()
