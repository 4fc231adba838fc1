"""The parallel-sampling entry point.

Counterpart of ``bayesfast/core/sample.py:26-220``. Differences that come
from running every chain in one accelerator program:

* All chains run in one jitted program (see ``samplers.chain``); the process
  pool, dask Pub/Sub progress channel, and per-worker thread limits disappear.
  The chain axis can be sharded over a device mesh (``parallel.mesh``).
* Progress printing happens between scan *chunks* (n_update iterations per
  chunk) on the host, covering all chains at once.
* Per-chain RNG streams come from ``jax.random.split`` of the trace's key.
"""

import time
import warnings

import numpy as np
import jax
import jax.numpy as jnp

from ..config import get_dtype
from ..samplers.chain import ChainCarry, ChainDriver
from ..samplers.metrics import init_diag_metric, init_full_metric
from ..samplers.sample_trace import (NTrace, HTrace, TNTrace, THTrace,
                                     CTrace,
                                     ETrace, TraceTuple)
from ..samplers.step_size import init_step_size, check_acceptance
from ..utils.sobol import multivariate_normal
from ..utils.random import spawn_generator


def _host_global(x):
    """Bring a device array to host as its GLOBAL value.

    On a multi-process mesh the jitted driver's outputs are sharded
    across processes and not fully addressable; ``np.asarray`` would
    raise. Every process gathers the full array (an allgather across
    processes), so the host-side trace/bookkeeping code is process-count
    agnostic — the multi-host analog of the reference's driver-side result gather
    (``bayesfast/core/sample.py:185-214``).
    """
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def _fetch_chunk(samples, stats_dict):
    """Bring one scan chunk to host in a SINGLE device->host transfer.

    Each fetch is a device round trip with a fixed cost; fetching samples
    plus ~12 stats arrays separately pays that cost ~13 times per chunk.
    Everything is packed into one array on device
    (stats cast to the sample dtype — exact: int32 stats stay below 2^24)
    and split back on host.
    """
    keys = list(stats_dict)
    dtype = samples.dtype
    arrs = [samples] + [stats_dict[k].astype(dtype)[..., None]
                        for k in keys]
    packed = _host_global(jnp.concatenate(arrs, axis=-1))
    d = samples.shape[-1]
    stats_np = {k: np.ascontiguousarray(packed[..., d + i].T)
                for i, k in enumerate(keys)}
    for k in keys:
        v = stats_dict[k]
        if v.dtype != dtype:
            stats_np[k] = stats_np[k].astype(v.dtype)
    return np.ascontiguousarray(packed[..., :d]), stats_np
from ..parallel.mesh import shard_chains
from .density import Density, DensityLite

__all__ = ['sample']


def _descend_x0(density, x_0, trace, dtype):
    """Batched gradient-ascent refinement of the starting points.

    Auto-drawn Sobol starts land wherever the prior volume puts them — for
    stiff bounded densities that can be |logp| ~ 1e6, where (a) warmup
    occasionally strands a chain in the far tail for the whole run (observed
    on banana-32 at the reference configuration: seed-dependent stuck chains
    with split-R-hat ~ 1.3 and a +0.3 bias on the GBS logz), and (b) float32
    energy differences round away entirely, breaking adaptation on the
    chip-native dtype. A short lockstep Adam ascent on the transformed logp
    moves every chain into the O(1)-curvature region first; each chain
    freezes as soon as its per-step gain drops below ``gain_tol`` (the scale
    where MC moves matter), so starts stay overdispersed rather than
    collapsing onto the mode.

    Returns ``(x_opt, n_evals)`` where ``n_evals`` is the per-chain count of
    density evaluations actually executed (for exact n_call accounting).
    """
    opts = trace.x_0_descent
    opts = dict(opts) if isinstance(opts, dict) else {}
    n_steps = int(opts.get('n_steps', 5000))
    lr = float(opts.get('lr', 0.3))
    gain_tol = float(opts.get('gain_tol', 0.1))
    b1, b2, eps_adam = 0.9, 0.999, 1e-8

    lpg = density.device_logp_and_grad(original_space=False)
    params = density.current_params()

    @jax.jit
    def run(x):
        lpg_b = jax.vmap(lambda xx: lpg(params, xx))
        lp0, g0 = lpg_b(x)
        frozen0 = ~jnp.isfinite(lp0)
        zeros = jnp.zeros_like(x)
        scale0 = jnp.ones(x.shape[0], x.dtype)
        init = (x, zeros, zeros, lp0, g0, scale0, frozen0, jnp.int32(0))

        def cond(c):
            return (c[7] < n_steps) & jnp.any(~c[6])

        def body(c):
            x, m, v, lp, g, scale, frozen, t = c
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * g * g
            tt = (t + 1).astype(x.dtype)
            m_hat = m_new / (1 - b1 ** tt)
            v_hat = v_new / (1 - b2 ** tt)
            x_prop = x + (lr * scale)[:, None] * m_hat / (
                jnp.sqrt(v_hat) + eps_adam)
            lp_new, g_new = lpg_b(x_prop)
            gain = lp_new - lp
            # per-chain backtracking: a finite, improving step advances the
            # state and relaxes the rate; an overshooting or non-finite one
            # is rejected, halves the rate and drops the stale momentum
            good = ~frozen & jnp.isfinite(lp_new) & (gain > 0)
            bad = ~frozen & ~good
            x = jnp.where(good[:, None], x_prop, x)
            g = jnp.where(good[:, None], g_new, g)
            lp = jnp.where(good, lp_new, lp)
            m = jnp.where(bad[:, None], 0.0, m_new)
            v = jnp.where(bad[:, None], v, v_new)
            scale = jnp.where(bad, scale * 0.5,
                              jnp.minimum(scale * 1.25, 1.0))
            # converged: accepted steps stopped gaining, or the rate
            # backtracked to nothing
            frozen = frozen | (good & (gain < gain_tol)) | (scale < 1e-6)
            return (x, m, v, lp, g, scale, frozen, t + 1)

        x, _, _, lp, _, _, _, t = jax.lax.while_loop(cond, body, init)
        return x, lp, t

    x_opt, lp, t = run(jnp.asarray(x_0, dtype))
    return np.asarray(x_opt), int(t) + 1


def _find_reasonable_step(density, x_0, trace, dtype, step0):
    """Per-chain 'find reasonable epsilon' probe (Stan's initialization,
    absent from the reference/pymc3 lineage).

    One batched leapfrog from each start measures the single-step
    acceptance; the step then doubles (acceptance > 0.5) or halves
    (acceptance < 0.5, or non-finite energy) until it crosses 0.5, per
    chain in lockstep. Without this, a divergent very first iteration sends
    dual averaging to ~1e-8 and — because ``mu = log(10 * step0)`` anchors
    the recovery — the step never climbs back, freezing the chain and
    collapsing its Welford metric (the stuck-chain mode documented in
    ``examples/banana_study.py``). float32 cold starts hit this on every
    chain; float64 hits it seed-dependently.

    Returns ``(eps, n_evals)``: per-chain reasonable steps and the count of
    density evaluations executed.
    """
    from ..samplers import nuts as _nuts
    from ..samplers.metrics import init_diag_metric, init_full_metric

    metric = trace.metric
    dim = x_0.shape[-1]
    if isinstance(metric, str):
        metric_arr = (np.ones(dim) if metric == 'diag' else np.eye(dim))
    else:
        metric_arr = np.asarray(metric)
    if metric_arr.ndim == 1:
        mstate = init_diag_metric(jnp.zeros(dim, dtype),
                                  jnp.asarray(metric_arr, dtype))
    else:
        mstate = init_full_metric(jnp.zeros(dim, dtype),
                                  jnp.asarray(metric_arr, dtype))
    metric_t = _nuts._metric_t(mstate)

    lpg = density.device_logp_and_grad(original_space=False)
    params = density.current_params()
    key = jax.random.fold_in(trace.random_generator, 0xf1d)
    n_steps = 60  # eps spans 2^60 at most — far past any useful range

    @jax.jit
    def run(x):
        lpg_b = jax.vmap(lambda xx: lpg(params, xx))

        def lpg_t(x_t):
            lp, g = lpg_b(x_t.T)
            return lp, g.T

        C = x.shape[0]
        from ..samplers.metrics import sample_momentum_b
        mb = jax.tree.map(lambda l: jnp.asarray(l, dtype), mstate)
        p0 = sample_momentum_b(mb, key, (C, dim), dtype)
        s0 = _nuts.compute_state_t(metric_t, lpg_t, x.T, p0.T)

        def accept_of(eps):
            s1 = _nuts.leapfrog_t(metric_t, lpg_t, eps, s0)
            d_energy = s1.energy - s0.energy
            return jnp.where(jnp.isfinite(d_energy),
                             jnp.exp(-jnp.minimum(d_energy, 80.0)), 0.0)

        eps = jnp.full((C,), float(step0), dtype)
        a = accept_of(eps)
        d = jnp.where(a > 0.5, 1.0, -1.0).astype(dtype)

        def cond(c):
            eps, frozen, t = c
            return (t < n_steps) & jnp.any(~frozen)

        def body(c):
            eps, frozen, t = c
            eps_new = jnp.where(frozen, eps, eps * jnp.exp2(d))
            a_new = accept_of(eps_new)
            crossed = jnp.where(d > 0, a_new <= 0.5, a_new > 0.5)
            # on a downward search keep the first acceptable (crossed) step;
            # on an upward search the crossing step overshot — keep it
            # anyway (Stan does), dual averaging corrects from there
            eps = jnp.where(frozen, eps, eps_new)
            return (eps, frozen | crossed, t + 1)

        eps, _, t = jax.lax.while_loop(
            cond, body, (eps, jnp.zeros((C,), bool), jnp.int32(0)))
        return eps, t

    eps, t = run(jnp.asarray(x_0, dtype))
    return np.asarray(eps), int(t) + 2  # init state + first probe


def _resolve_trace(sample_trace, sampler):
    if isinstance(sample_trace, TNTrace):
        return sample_trace, 'TNUTS'
    if isinstance(sample_trace, THTrace):
        return sample_trace, 'THMC'
    if isinstance(sample_trace, CTrace):
        return sample_trace, 'CHEES'
    if isinstance(sample_trace, NTrace):
        return sample_trace, 'NUTS'
    if isinstance(sample_trace, HTrace):
        return sample_trace, 'HMC'
    if isinstance(sample_trace, ETrace):
        return sample_trace, 'Ensemble'
    if sample_trace is None or isinstance(sample_trace, dict):
        sample_trace = {} if sample_trace is None else sample_trace
        cls = {'NUTS': NTrace, 'HMC': HTrace, 'TNUTS': TNTrace,
               'THMC': THTrace, 'Ensemble': ETrace,
               'CHEES': CTrace}.get(sampler)
        if cls is None:
            raise ValueError('unexpected value for sampler.')
        return cls(**sample_trace), sampler
    if isinstance(sample_trace, TraceTuple):
        return sample_trace.trace, sample_trace.sampler
    raise ValueError('unexpected value for sample_trace.')


def _init_carry(trace, x_0, dtype, tempered=False, algo=None, eps_0=None):
    """Build the batched per-chain carry (RNG keys, q, step size, metric).

    For tempered samplers the position vector is extended to ``[u, q...]``
    with ``u ~ N(0, 1)`` per chain (``base_hmc.py:242``); the metric and
    step-size scaling stay q-space.
    """
    n_chain = trace.n_chain
    dim = x_0.shape[-1]

    keys = jnp.stack(spawn_generator(trace.random_generator, n_chain))
    q = jnp.asarray(x_0, dtype)
    if tempered:
        u0 = jax.random.normal(
            jax.random.fold_in(trace.random_generator, 0x7e), (n_chain, 1),
            dtype)
        q = jnp.concatenate([u0, q], axis=1)

    step0 = trace.step_size if trace.step_size is not None else 1.0
    step0 = step0 / dim ** 0.25  # ``sample_trace.py:365-373``
    if eps_0 is not None and algo == 'chees':
        step0 = float(np.exp(np.mean(np.log(eps_0))))  # shared chees state
    if algo == 'chees':
        # shared scalar adaptation state (step size + trajectory length);
        # copy every leaf: jax dedupes equal scalar constants into one
        # buffer, which breaks carry donation ("donate the same buffer
        # twice") when e.g. adam_m and adam_v are both zeros
        from ..samplers.chees import init_chees_adapt
        ss = jax.tree.map(lambda a: jnp.array(a, copy=True),
                          init_chees_adapt(step0, trace.traj_len_0, dtype))
    elif eps_0 is not None:
        # per-chain reasonable steps from the pre-adaptation probe; copy
        # each leaf — log_step/log_bar start equal and would otherwise
        # alias one buffer, breaking carry donation
        ss = jax.tree.map(jnp.copy, jax.vmap(
            lambda e: init_step_size(e, dtype))(jnp.asarray(eps_0, dtype)))
    else:
        ss = jax.vmap(lambda _: init_step_size(
            jnp.asarray(step0, dtype), dtype))(jnp.arange(n_chain))

    metric = trace.metric
    if isinstance(metric, str):
        metric_arr = (np.ones(dim) if metric == 'diag' else np.eye(dim))
    else:
        metric_arr = np.asarray(metric)
    init_mean = (np.asarray(x_0) if trace.initial_mean is None
                 else np.broadcast_to(trace.initial_mean, (n_chain, dim)))

    def init_one(mean):
        if metric_arr.ndim == 1:
            return init_diag_metric(mean, jnp.asarray(metric_arr, dtype),
                                    trace.initial_weight, trace.adapt_window)
        return init_full_metric(mean, jnp.asarray(metric_arr, dtype),
                                trace.initial_weight, trace.adapt_window)

    if getattr(trace, 'pooled_metric', False):
        # one shared metric fed by all chains
        ms = init_one(jnp.asarray(np.mean(init_mean, axis=0), dtype))
    else:
        ms = jax.vmap(init_one)(jnp.asarray(init_mean, dtype))
    return ChainCarry(keys, q, ss, ms)


def _run_ensemble(density, trace, x_0, n_run, i_iter, verbose, n_update,
                  mesh, dtype):
    """Stretch-move ensemble sampling path (no gradients needed)."""
    from ..samplers.ensemble import run_ensemble
    from ..utils.random import next_key

    if trace.n_chain % 2:
        raise ValueError('the ensemble sampler needs an even n_chain.')

    logp_scalar = density.device_logp(original_space=False)
    runner = jax.jit(lambda key, x, wf: run_ensemble(
        key, x, logp_scalar, len(wf), wf, trace.a),
        static_argnames=())

    if trace._carry is not None:
        key, x = trace._carry[0], jnp.asarray(trace._carry[1])
    else:
        key = jax.random.fold_in(trace.random_generator, 0xe5)
        x = jnp.asarray(x_0, dtype)
        trace._chain_initialized = True
    x = shard_chains(x, trace.n_chain, mesh)

    if n_update is None:
        n_update = max(n_run // 5, 1)
    all_samples, all_stats = [], []
    t_start = time.time()
    done = 0
    while done < n_run:
        n_step = min(int(n_update), n_run - done)
        warmup_flags = jnp.asarray(
            (i_iter + done + np.arange(n_step)) < trace.n_warmup)
        key, sub = jax.random.split(key)
        x, lp, samples, stats = runner(sub, x, warmup_flags)
        all_samples.append(np.swapaxes(np.asarray(samples), 0, 1))
        all_stats.append({k: np.asarray(v).T for k, v in
                          stats._asdict().items()})
        done += n_step
        if verbose:
            print(f' WALKERS [0-{trace.n_chain - 1}] : ensemble proceeding '
                  f'[ {i_iter + done} / {trace.n_iter} ].')

    samples = np.concatenate(all_samples, axis=1)
    stats_arrays = {k: np.concatenate([s[k] for s in all_stats], axis=1)
                    for k in all_stats[0]}
    trace._append_results(samples, stats_arrays)
    trace._carry = (key, np.asarray(x))
    trace._samples_original = np.asarray(density.to_original(trace._samples))
    trace._logp_original = np.asarray(density.to_original_density(
        trace.logp.reshape(-1), x_trans=trace._samples.reshape(
            (-1, trace._samples.shape[-1])))).reshape(trace.logp.shape)
    if verbose:
        print(f' WALKERS [0-{trace.n_chain - 1}] : ensemble finished '
              f'[ {trace.i_iter} / {trace.n_iter} ] in '
              f'{time.time() - t_start:.2f} seconds.')
    return TraceTuple(trace)


def sample(density, sample_trace=None, sampler='NUTS', n_run=None,
           parallel_backend=None, verbose=True, n_update=None, mesh=None):
    """Sample a probability density; returns a ``TraceTuple``.

    See ``bayesfast.core.sample.sample`` for the original semantics. The
    ``parallel_backend`` argument is accepted for API compatibility and
    ignored (parallelism is the device mesh); ``mesh`` optionally overrides
    the global mesh from ``parallel.mesh.set_mesh``.
    """
    if not isinstance(density, (Density, DensityLite)):
        raise ValueError('density should be a Density or DensityLite.')

    trace, sampler = _resolve_trace(sample_trace, sampler)
    dtype = get_dtype()

    # ------- starting points (``sample.py:102-116``) -------
    x_0_auto = trace.x_0 is None
    if trace.x_0 is None:
        dim = density.input_size
        if dim is None:
            raise RuntimeError('Neither SampleTrace.x_0 nor Density'
                               '/DensityLite.input_size is defined.')
        trace._x_0 = multivariate_normal(
            np.zeros(dim), np.eye(dim), trace.n_chain)
        trace._x_0_transformed = True
    elif not trace.x_0_transformed:
        trace._x_0 = np.asarray(density.from_original(trace._x_0))
        trace._x_0_transformed = True
    x_0 = np.atleast_2d(trace._x_0)
    if x_0.shape[0] == trace.n_chain:
        pass
    elif x_0.shape[0] == 1:
        x_0 = np.broadcast_to(x_0, (trace.n_chain, x_0.shape[-1]))
    else:
        # pick one random row per chain (``sample_trace.py:194-199``)
        pick_key = jax.random.fold_in(trace.random_generator, 0x517)
        idx = np.asarray(jax.random.randint(
            pick_key, (trace.n_chain,), 0, x_0.shape[0]))
        x_0 = x_0[idx]

    # ------- start refinement (fresh gradient-sampler runs only) -------
    descent = getattr(trace, 'x_0_descent', False)
    if descent == 'auto':
        descent = x_0_auto
    if (descent and trace._carry is None and not trace.chain_initialized
            and sampler != 'Ensemble'):
        x_0, n_evals = _descend_x0(density, x_0, trace, dtype)
        trace._descent_calls = trace.n_chain * n_evals

    # ------- iteration bookkeeping (``base_hmc.py:98-111``) -------
    i_iter = trace.i_iter
    if n_run is None:
        n_run = trace.n_iter - i_iter
    else:
        n_run = int(n_run)
        if n_run <= 0:
            raise ValueError('invalid value for n_run.')
        if n_run > trace.n_iter - i_iter:
            trace.n_iter = i_iter + n_run
    if n_run == 0:
        return TraceTuple(trace)

    # ------- pre-run finite check (``base_hmc.py:42-46``) — only for a
    # fresh start; continuation calls resume from a carry whose state was
    # produced by finite transitions, and the check is a full device round
    # trip per call -------
    if getattr(trace, '_carry', None) is None:
        if sampler == 'Ensemble':  # gradient-free sampler: logp only
            logp_0 = density.logp(x_0, original_space=False)
            if not np.isfinite(logp_0).all():
                raise ValueError('failed to get finite logp at x_0.')
        else:
            logp_0, grad_0 = density.logp_and_grad(x_0,
                                                   original_space=False)
            if not (np.isfinite(logp_0).all()
                    and np.isfinite(grad_0).all()):
                raise ValueError('failed to get finite logp and/or grad '
                                 'at x_0.')

    # ------- driver + carry -------
    if sampler == 'Ensemble':
        return _run_ensemble(density, trace, x_0, n_run, i_iter, verbose,
                             n_update, mesh, dtype)

    algo = {'NUTS': 'nuts', 'HMC': 'hmc', 'TNUTS': 'tnuts',
            'THMC': 'thmc', 'CHEES': 'chees'}[sampler]
    tempered = algo in ('tnuts', 'thmc')
    base_lpg = None
    base_density = None
    if tempered:
        base_density = trace.density_base
        if base_density is None:
            raise ValueError('tempered samplers need trace.density_base.')
        logxi = trace.logxi
        _blpg = base_density.device_logp_and_grad(original_space=False)

        def base_lpg(params, x, _f=_blpg, _xi=logxi):
            lp, g = _f(params, x)
            return lp + _xi, g  # ``base_hmc.py:228-231``

    # reuse the compiled driver across continuation calls on the same
    # (trace, density) pair — a fresh ChainDriver would recompile the whole
    # sampling program every bf.sample invocation
    cached = getattr(trace, '_driver_cache', None)
    cache_key = (id(density), algo)
    if cached is not None and cached[0] == cache_key:
        driver = cached[1]
    else:
        driver = ChainDriver(
            density.device_logp_and_grad(original_space=False),
            algorithm=algo,
            max_treedepth=getattr(trace, 'max_treedepth', 10),
            n_int_step=getattr(trace, 'n_int_step', 32),
            max_change=trace.max_change, target_accept=trace.target_accept,
            gamma=trace.gamma, k=trace.k, t_0=trace.t_0,
            adapt_step_size=trace.adapt_step_size,
            update_window=trace.update_window, doubling=trace.doubling,
            adapt_metric=trace.adapt_metric, logp_and_grad_base=base_lpg,
            pooled_metric=getattr(trace, 'pooled_metric', False),
            max_leapfrogs=getattr(trace, 'max_leapfrogs', 1024),
            adapt_traj_len=getattr(trace, 'adapt_traj_len', True),
            chees_lr=getattr(trace, 'chees_lr', 0.025))
        trace._driver_cache = (cache_key, driver)

    if trace._carry is not None:
        carry = jax.tree.map(jnp.asarray, trace._carry)
    else:
        eps_0 = None
        if getattr(trace, 'step_probe', False):
            step0 = trace.step_size if trace.step_size is not None else 1.0
            step0 = step0 / x_0.shape[-1] ** 0.25
            eps_0, n_ev = _find_reasonable_step(density, x_0, trace, dtype,
                                                step0)
            trace._descent_calls += trace.n_chain * n_ev
        carry = _init_carry(trace, x_0, dtype, tempered, algo, eps_0)
        trace._chain_initialized = True
    carry = shard_chains(carry, trace.n_chain, mesh)

    # ------- chunked run with progress reporting -------
    if n_update is None:
        n_update = max(n_run // 5, 1)
    else:
        n_update = max(int(n_update), 1)

    all_samples, all_stats = [], []
    t_start = time.time()
    done = 0
    while done < n_run:
        n_step = min(n_update, n_run - done)
        warmup_flags = (i_iter + done + np.arange(n_step)) < trace.n_warmup
        t_i = time.time()
        params = density.current_params()
        if tempered:
            params = (params, base_density.current_params())
        carry, (samples, (stats, extras)) = driver.run(
            carry, warmup_flags, params)
        samples, stats_np = _fetch_chunk(samples,
                                         {**stats._asdict(), **extras})
        if tempered:
            samples = samples[..., 1:]  # strip the tempering coordinate
        all_samples.append(np.swapaxes(samples, 0, 1))
        all_stats.append(stats_np)
        done += n_step
        if verbose:
            t_d = time.time() - t_i
            n_div = int(stats_np['diverging'].sum())
            msg = (f' CHAINS [0-{trace.n_chain - 1}] : sampling proceeding '
                   f'[ {i_iter + done} / {trace.n_iter} ], last {n_step} '
                   f'samples used {t_d:.2f} seconds')
            msg += (f', while divergence encountered in {n_div} sample(s).'
                    if n_div / (n_step * trace.n_chain) > 0.05 else '.')
            if (i_iter + done) <= trace.n_warmup:
                msg += ' (warmup)'
            print(msg)

    samples = np.concatenate(all_samples, axis=1)
    stats_arrays = {k: np.concatenate([s[k] for s in all_stats], axis=1)
                    for k in all_stats[0]}
    trace._append_results(samples, stats_arrays)
    # the carry STAYS on device: fetching its ~20 leaves would cost one
    # device round trip each. Resume consumes it directly; checkpoint save
    # gathers lazily (see utils/checkpoint._HostPickler).
    trace._carry = carry

    # back-transform to original space (``sample.py:175-177``) —
    # INCREMENTALLY: only this call's new samples run through the
    # transform; re-transforming the whole history made every
    # continuation call's tail grow with the run length (and each eager
    # transform is a dispatch+fetch round trip)
    prev_s = getattr(trace, '_samples_original', None)
    prev_l = getattr(trace, '_logp_original', None)
    new_s = np.asarray(density.to_original(samples))
    new_logp = stats_arrays['logp']
    new_l = np.asarray(density.to_original_density(
        new_logp.reshape(-1), x_trans=samples.reshape(
            (-1, samples.shape[-1])))).reshape(new_logp.shape)
    if (prev_s is not None and
            prev_s.shape[1] + samples.shape[1] == trace._samples.shape[1]):
        trace._samples_original = np.concatenate([prev_s, new_s], axis=1)
        trace._logp_original = np.concatenate([prev_l, new_l], axis=1)
    else:
        trace._samples_original = np.asarray(
            density.to_original(trace._samples))
        trace._logp_original = np.asarray(density.to_original_density(
            trace.logp.reshape(-1), x_trans=trace._samples.reshape(
                (-1, trace._samples.shape[-1])))).reshape(trace.logp.shape)

    if verbose:
        t_f = time.time() - t_start
        print(f' CHAINS [0-{trace.n_chain - 1}] : sampling finished '
              f'[ {trace.i_iter} / {trace.n_iter} ], obtained {n_run} '
              f'samples per chain in {t_f:.2f} seconds.')

    if 'diverging' in stats_arrays:
        post_div = stats_arrays['diverging'][:, trace.n_warmup:]
        if post_div.size:
            frac = float(np.mean(post_div))
            if frac > 0.05:
                warnings.warn(
                    f'{frac:.1%} of post-warmup transitions diverged: the '
                    'posterior has geometry the adapted step size cannot '
                    'integrate (results may be biased toward the bulk). '
                    'Consider a higher target_accept, a reparametrization, '
                    'or float64.', RuntimeWarning)

    if 'tree_depth' in stats_arrays:
        post = stats_arrays['tree_depth'][:, trace.n_warmup:]
        max_td = getattr(trace, 'max_treedepth', 10)
        if post.size and np.mean(post >= max_td) > 0.5:
            warnings.warn(
                'more than half of the post-warmup NUTS trees hit '
                f'max_treedepth={max_td}: the adapted step size is too small '
                'for full trajectories (common for very stiff targets in '
                'float32). Consider raising max_treedepth, running in '
                'float64, or reparametrizing.', RuntimeWarning)

    if not np.all(stats_arrays['warmup'][:, -1:]):
        # post-warmup acceptance check per chain (``step_size.py:53-68``);
        # chees keeps one shared step state, so check it once. The carry is
        # device-resident — bring the step state to host in ONE transfer
        # per leaf first, or the per-chain a[i] indexing below becomes
        # n_chain separate device round trips
        ss = jax.tree.map(_host_global, trace._carry.step)
        if getattr(ss, 'log_step', None) is None:  # CheesAdaptState
            msg = check_acceptance(ss.step, trace.target_accept, None)
            if msg is not None:
                warnings.warn(msg, RuntimeWarning)
        else:
            for i in range(trace.n_chain):
                si = jax.tree.map(lambda a: a[i], ss)
                msg = check_acceptance(si, trace.target_accept, i)
                if msg is not None:
                    warnings.warn(msg, RuntimeWarning)

    return TraceTuple(trace)
