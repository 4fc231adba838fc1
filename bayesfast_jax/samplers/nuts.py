"""Iterative No-U-Turn transition kernel, batch-first over chains.

Accelerator reformulation of the reference's recursive tree builder
(``bayesfast/samplers/nuts.py:22-217``, a modified pymc3 NUTS). Recursion is
control-flow the XLA compiler cannot trace, so the binary tree is built
*iteratively* with a fixed-size checkpoint stack (one frame per depth level,
the classic binary-counter merge): after leaf ``k`` is integrated it is merged
with the stack top once per trailing 1-bit of ``k``, which reproduces the
recursive merge order exactly.

Design — ONE flat ``lax.while_loop`` over *leaf iterations*, written
batch-first (the chain axis is explicit in every array, nothing is vmapped),
with a **chain-minor layout**: every vector is (dim, chains) and the
checkpoint stack is (levels, width, chains), so the chain axis is the
contiguous minor dimension. (The layout was chosen for a tiled accelerator
on which a minor dim of D=32 padded to 128; whether it matters on the GPU
is not measured.)

The central structural fact the kernel exploits: **every still-active lane
shares the same tree schedule.** A lane leaves the common schedule only by
diverging, U-turning, or hitting max depth — and each of those finishes the
lane — so the loop counters (leaf index ``k``, merge level ``m``, pending
merge count, depth, leaf-vs-merge phase) are *scalars*, not per-lane arrays.
That buys three wins over a one-hot formulation (the profiles that chose
them were not taken on the GPU):

  * checkpoint-stack access is a scalar-indexed ``dynamic_slice`` /
    ``dynamic_update_slice`` (O(width x chains) per iteration) instead of a
    one-hot select over every level (O(levels x width x chains));
  * every iteration integrates one leaf AND performs all of that leaf's
    binary-counter merges: the first merge is fused against the live leaf
    state (no frame materialized, static stack level 0, 2 U-turn dots
    instead of 6), deeper merges run in a rarely-entered inner loop — so a
    depth-d subtree takes exactly 2^d iterations (rather than 1.5 * 2^d
    with merge-only passes paying full per-iteration overhead);
  * the stack stores only momenta — endpoint *velocities* are recomputed
    from ``M^{-1} p`` at merge time, cutting the stored frame from 5 to 3
    vectors (memory traffic scales with frame width).

Further layout decisions:

  * a vmapped ``while_loop`` is batched by re-running the body until *all*
    lanes finish and selecting the whole carry per iteration — with nested
    tree loops, finished chains re-integrate their entire subtree at every
    outer doubling. The flat loop advances every lane every iteration.
  * each leaf iteration performs the leapfrog AND the first binary-counter
    merge; only leaves with >= 2 trailing 1-bits need extra merge-only
    iterations, cutting iterations per subtree from 2*2^d to 1.5*2^d. The
    final push of a completed subtree is skipped (nothing ever reads it), so
    the stack needs only ``max_treedepth - 1`` live levels (plus one
    write-sink level so the per-iteration push is unconditional and stays an
    in-place dynamic-update).

Semantics faithfully kept from the reference (they affect sampling statistics):
  * multinomial proposal sampling via ``logbern(log_size2 - log_size_total)``
    at every merge (``nuts.py:81-85, 163-167``);
  * the generalized U-turn check ``p_sum . v_left <= 0 or p_sum . v_right <= 0``
    plus the *extra* inner-subtree checks at merged depth > 1 and at every
    main-tree extension (``nuts.py:88-101, 148-161``);
  * divergence when ``|E - E_0| >= max_change`` with nan -> inf
    (``nuts.py:113-128``);
  * per-leaf acceptance statistics ``min(1, exp(-dE))`` accumulated over all
    non-divergent proposals (``nuts.py:120-130``);
  * aborted extensions (divergence/turning inside the new subtree) do not
    merge the subtree's proposal or momentum sum (``nuts.py:78-79``).
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .metrics import DiagMetricState, sample_momentum_b

__all__ = ['NutsStats', 'nuts_transition', 'nuts_transition_batched',
           'nuts_core_batched']


class NutsStats(NamedTuple):
    logp: jnp.ndarray
    energy: jnp.ndarray
    tree_depth: jnp.ndarray
    tree_size: jnp.ndarray
    mean_tree_accept: jnp.ndarray
    energy_change: jnp.ndarray
    max_energy_change: jnp.ndarray
    diverging: jnp.ndarray


class _Proposal(NamedTuple):
    q: jnp.ndarray       # (D, C)
    energy: jnp.ndarray  # (C,)
    logp: jnp.ndarray    # (C,)


class TIntegratorState(NamedTuple):
    """Lane-minor Hamiltonian state: vectors are (D, C), scalars (C,).

    ``cq``/``cp`` are Kahan compensation residuals for the position and
    momentum accumulators: a float32 trajectory of ~1000 leapfrog steps
    loses ~1e-7 of |q| at every ``q += eps * v``; compensated accumulation
    keeps the integrator's own rounding at float64 grade while every
    expensive op (the user logp/grad) stays in the chip-native dtype.

    A larger float32 error source lives *outside* the integrator: under
    the default precision XLA may run f32 matmuls at reduced precision
    (TF32 on NVIDIA tensor cores), and any matmul inside the target
    density then injects relative gradient noise that breaks energy
    conservation. The package therefore forces
    ``jax_default_matmul_precision='highest'`` at import — see
    ``config.set_matmul_precision``.
    """
    q: jnp.ndarray
    p: jnp.ndarray
    v: jnp.ndarray
    grad: jnp.ndarray
    energy: jnp.ndarray
    logp: jnp.ndarray
    cq: jnp.ndarray
    cp: jnp.ndarray


def _metric_t(metric):
    """Transpose a Diag/FullMetricState's payload to lane-minor once."""
    if isinstance(metric, DiagMetricState):
        var = metric.var
        return ('diag', var.T if var.ndim == 2 else var[:, None])
    cov = metric.cov
    return ('full', jnp.moveaxis(cov, 0, -1) if cov.ndim == 3 else cov)


def _make_vel_fn(metric_t):
    """Lane-minor ``M^{-1} p`` closure accepting any leading batch dims:
    ``p`` is (..., D, C). The tree kernel stores only momenta and recomputes
    endpoint velocities at merge time through this."""
    kind, payload = metric_t
    if kind == 'diag':
        return lambda p: payload * p
    if payload.ndim == 3:
        return lambda p: jnp.einsum('ijc,...jc->...ic', payload, p)
    return lambda p: jnp.einsum('ij,...jc->...ic', payload, p)


def _velocity_t(metric_t, p):
    """Lane-minor ``M^{-1} p`` for a single (D, C) vector."""
    return _make_vel_fn(metric_t)(p)


def compute_state_t(metric_t, lpg_t, q, p):
    """Lane-minor Hamiltonian state; ``lpg_t`` maps (D, C) -> ((C,), (D, C))."""
    logp, grad = lpg_t(q)
    v = _velocity_t(metric_t, p)
    energy = 0.5 * jnp.sum(p * v, axis=0) - logp
    zero = jnp.zeros_like(q)
    return TIntegratorState(q, p, v, grad, energy, logp, zero, zero)


def _kahan_add(x, c, delta):
    """One compensated accumulation ``x += delta`` with residual ``c``."""
    y = delta - c
    t = x + y
    c_new = (t - x) - y
    return t, c_new


def leapfrog_t(metric_t, lpg_t, eps, s):
    """Lane-minor leapfrog step; ``eps`` is (C,) signed per-chain steps
    (broadcasts against (D, C) along the minor chain axis). Position and
    momentum updates accumulate with Kahan compensation (see
    ``TIntegratorState``)."""
    dt = 0.5 * eps
    p_half, cp = _kahan_add(s.p, s.cp, dt * s.grad)
    v_half = _velocity_t(metric_t, p_half)
    q_new, cq = _kahan_add(s.q, s.cq, eps * v_half)
    logp, grad = lpg_t(q_new)
    p_new, cp = _kahan_add(p_half, cp, dt * grad)
    v_new = _velocity_t(metric_t, p_new)
    energy = 0.5 * jnp.sum(p_new * v_new, axis=0) - logp
    return TIntegratorState(q_new, p_new, v_new, grad, energy, logp, cq, cp)


def _bwhere(mask, new, old):
    """Select over a state pytree; ``mask`` (C,) broadcasts against the
    minor chain axis of every (…, C) leaf."""
    return jax.tree.map(lambda n, o: jnp.where(mask, n, o), new, old)


class _TreeLayout:
    """Flat-vector layout of a subtree summary, lane-minor.

    Rows ``[left_p(D) | right_p(D) | p_sum(D) | log_size(1) | prop(P)]``
    over columns = chains, so stack frames and merge selects are single
    fused passes with the chain axis minor. Endpoint
    velocities are NOT stored — merges recompute them via the metric.
    """

    def __init__(self, dim, prop_example):
        self.dim = dim
        leaves = jax.tree.leaves(prop_example)
        self.prop_treedef = jax.tree.structure(prop_example)
        self.prop_shapes = [jnp.shape(l)[:-1] for l in leaves]
        self.prop_sizes = [max(1, int(np.prod(jnp.shape(l)[:-1])))
                           for l in leaves]
        self.prop_len = sum(self.prop_sizes)
        self.total = 3 * dim + 1 + self.prop_len
        d = dim
        self.sl_left_p = slice(0, d)
        self.sl_right_p = slice(d, 2 * d)
        self.sl_p_sum = slice(2 * d, 3 * d)
        self.i_log_size = 3 * d
        self.sl_prop = slice(3 * d + 1, self.total)

    def flat_prop(self, prop):
        leaves = jax.tree.leaves(prop)
        return jnp.concatenate(
            [l.reshape(-1, l.shape[-1]) for l in leaves], axis=0)

    def unflat_prop(self, vec):
        parts = []
        off = 0
        for shp, sz in zip(self.prop_shapes, self.prop_sizes):
            part = vec[off:off + sz]
            parts.append(part.reshape(shp + (vec.shape[-1],))
                         if shp else part[0])
            off += sz
        return jax.tree.unflatten(self.prop_treedef, parts)

    def leaf(self, state, d_energy, prop_of):
        return jnp.concatenate([
            state.p, state.p, state.p,
            -d_energy[None], self.flat_prop(prop_of(state))], axis=0)


def _merge_b(u, L, vel_fn, t1, t2, merged_depth):
    """Join adjacent flat subtrees t1 (older/left of) and t2 (newer/right):
    t1/t2 are (total, C), ``u`` (C,) uniforms, ``merged_depth`` a scalar.

    Mirrors the join in ``nuts.py:146-167`` including the extra U-turn
    checks when the merged depth exceeds 1; the six U-turn dot products run
    as one packed (6, D, C) contraction with the four endpoint velocities
    recomputed from the stored momenta in one batched ``vel_fn`` call.
    """
    ps1 = t1[L.sl_p_sum]
    ps2 = t2[L.sl_p_sum]
    p_sum = ps1 + ps2
    p_sum1 = ps1 + t2[L.sl_left_p]
    p_sum2 = t1[L.sl_right_p] + ps2
    ends_v = vel_fn(jnp.stack(
        [t1[L.sl_left_p], t1[L.sl_right_p],
         t2[L.sl_left_p], t2[L.sl_right_p]], axis=0))
    v1l, v1r, v2l, v2r = ends_v
    lhs = jnp.stack([p_sum, p_sum, p_sum1, p_sum1, p_sum2, p_sum2], axis=0)
    rhs = jnp.stack([v1l, v2r, v1l, v2l, v1r, v2r], axis=0)
    dots = jnp.sum(lhs * rhs, axis=1)
    turning = (dots[0] <= 0) | (dots[1] <= 0)
    turning1 = (dots[2] <= 0) | (dots[3] <= 0)
    turning2 = (dots[4] <= 0) | (dots[5] <= 0)
    turning = turning | ((merged_depth > 1) & (turning1 | turning2))

    ls1 = t1[L.i_log_size]
    ls2 = t2[L.i_log_size]
    log_size = jnp.logaddexp(ls1, ls2)
    take2 = jnp.log(u) < ls2 - log_size
    tail = jnp.where(take2, t2[L.sl_prop], t1[L.sl_prop])
    merged = jnp.concatenate([
        t1[L.sl_left_p], t2[L.sl_right_p], p_sum,
        log_size[None], tail], axis=0)
    return merged, turning


def _merge_leaf(u, L, vel_fn, t1, state, d_energy, prop_of):
    """Join the depth-1 subtree t1 (a single older leaf, stack level 0)
    with the just-integrated leaf ``state`` — the specialized first
    binary-counter merge, fused into the leaf iteration.

    At merged depth 1 the extra inner-subtree U-turn checks of
    ``nuts.py:148-161`` do not apply, so only the two outer dot products
    run; the new leaf's endpoint momenta/p_sum are all ``state.p`` and its
    velocity is already in ``state.v``, so no frame is materialized and
    only t1's left endpoint velocity is recomputed.
    """
    ps1 = t1[L.sl_p_sum]
    p_sum = ps1 + state.p
    v1l = vel_fn(t1[L.sl_left_p])
    turning = ((jnp.sum(p_sum * v1l, axis=0) <= 0) |
               (jnp.sum(p_sum * state.v, axis=0) <= 0))
    ls1 = t1[L.i_log_size]
    ls2 = -d_energy
    log_size = jnp.logaddexp(ls1, ls2)
    take2 = jnp.log(u) < ls2 - log_size
    tail = jnp.where(take2, L.flat_prop(prop_of(state)), t1[L.sl_prop])
    merged = jnp.concatenate([
        t1[L.sl_left_p], state.p, p_sum, log_size[None], tail], axis=0)
    return merged, turning


def _trailing_ones(k):
    """Number of trailing 1-bits of k = number of binary-counter merges
    after integrating leaf ``k``."""
    x = k + 1
    return jax.lax.population_count((x & -x) - 1)


def nuts_core_batched(key, start, step_fn, prop_of, step_size, max_treedepth,
                      max_change, vel_fn):
    """Batch-first iterative tree-doubling core over any lane-minor
    integrator state with ``.q/.p/.v/.energy/.logp`` fields — vectors
    (D, C), scalars (C,) (shared by NUTS and tempered TNUTS).

    ``step_fn(eps, state)`` integrates one batched leapfrog step with
    per-chain signed steps ``eps`` of shape (C,). ``step_size`` is (C,)
    positive. ``vel_fn(p)`` maps stored momenta of shape (..., D, C) to
    velocities ``M^{-1} p`` (see ``_make_vel_fn``). Returns a dict of
    batched results (proposal pytree, depth, tree size, acceptance
    statistics, divergence flag, loop_iters).

    The loop counters (``k``, ``depth_s``) are scalars: every lane still in
    flight shares the same schedule, because the only ways to deviate from
    it (divergence, U-turn, max depth) all finish the lane. Finished lanes
    keep integrating as masked passengers; their stack frames may go stale
    but are never read.

    Every iteration integrates exactly one leaf and performs ALL of that
    leaf's binary-counter merges in the same pass: the first merge is fused
    against the just-integrated state (``_merge_leaf`` — static stack level
    0, no frame materialized, two U-turn dots), and the rare deeper merges
    (leaves with >= 2 trailing 1-bits, 1/4 of leaves) run in an inner
    ``while_loop`` entered through a scalar ``cond``. A depth-d subtree
    thus takes exactly 2^d iterations (the round-2 kernel took 1.5 * 2^d,
    paying full per-iteration overhead on merge-only passes).
    """
    D, C = start.q.shape
    dtype = start.q.dtype
    L = _TreeLayout(D, prop_of(start))
    # a depth-d subtree reads levels 0..d-2 and writes 0..d-1 (its final
    # merge result goes straight to the main tree), and d <= max_treedepth-1;
    # one extra level is the write sink for iterations with nothing to push
    n_lvl = max(int(max_treedepth) - 1, 1)
    start_energy = start.energy

    key, k0 = jax.random.split(key)
    go_right0 = jax.random.uniform(k0, (C,)) < 0.5
    eps0 = jnp.where(go_right0, step_size, -step_size).astype(dtype)

    init = dict(
        key=key,
        cur=start, left=start, right=start,
        prop=L.flat_prop(prop_of(start)),
        p_sum=start.p,
        log_size=jnp.zeros((C,), dtype),
        stack=jnp.zeros((n_lvl + 1, L.total, C), dtype),
        # scalar schedule
        k=jnp.zeros((), jnp.int32),
        depth_s=jnp.zeros((), jnp.int32),
        # per-lane state
        depth=jnp.zeros((C,), jnp.int32),
        go_right=go_right0,
        eps=eps0,
        accept_sum=jnp.zeros((C,), dtype),
        n_prop=jnp.zeros((C,), jnp.int32),
        max_de=jnp.zeros((C,), dtype),
        diverging=jnp.zeros((C,), bool),
        done=jnp.zeros((C,), bool),
        loop_iters=jnp.zeros((), jnp.int32),
    )

    def cond(c):
        return jnp.any(~c['done'])

    def body(c):
        key, sub = jax.random.split(c['key'])
        u = jax.random.uniform(sub, (3, C))
        active = ~c['done']

        # ---- leaf: one leapfrog, every iteration ----
        new_state = step_fn(c['eps'], c['cur'])
        d_energy = new_state.energy - start_energy
        d_energy = jnp.where(jnp.isnan(d_energy), jnp.inf, d_energy)
        div = active & ~(jnp.abs(d_energy) < max_change)
        upd = active & (jnp.abs(d_energy) > jnp.abs(c['max_de']))
        max_de = jnp.where(upd, d_energy, c['max_de'])
        accept = jnp.minimum(1.0, jnp.exp(-d_energy))
        accept_sum = c['accept_sum'] + jnp.where(active & ~div, accept, 0.)
        n_prop = c['n_prop'] + active.astype(jnp.int32)
        cur = _bwhere(active & ~div, new_state, c['cur'])
        diverging = c['diverging'] | div

        pending = _trailing_ones(c['k'])

        # ---- first binary-counter merge, fused against the leaf state and
        # computed UNCONDITIONALLY with a scalar select: a ``lax.cond``
        # here forces pass-through copies of the frame every iteration
        # (a conditional materializes its operands and results). When
        # ``pending == 0`` the merge math runs on a stale stack frame and
        # is discarded by the select — stale frames hold finite momenta, so
        # no NaNs propagate. Lanes that diverged or are finished keep a
        # stale frame (their lane ends this iteration, it is never read).
        t1 = c['stack'][0]
        merged, mturn = _merge_leaf(u[0], L, vel_fn, t1, new_state,
                                    d_energy, prop_of)
        leaf_vec = L.leaf(new_state, d_energy, prop_of)
        ok_merge = active & ~div
        did_first = pending > 0  # scalar: shared tree schedule
        inc = jnp.where(did_first, jnp.where(ok_merge, merged, t1), leaf_vec)
        turned = did_first & ok_merge & mturn

        # ---- deeper merges (trailing 1-bits >= 2): inner loop over the
        # remaining levels, entered only when needed so the common path
        # pays nothing
        def extra_merges(args):
            key, inc, turned = args

            def e_cond(s):
                return s[2] < pending

            def e_body(s):
                key, inc, m, turned = s
                key, s2 = jax.random.split(key)
                um = jax.random.uniform(s2, (C,))
                t1 = jax.lax.dynamic_index_in_dim(c['stack'], m, axis=0,
                                                  keepdims=False)
                merged, mturn = _merge_b(um, L, vel_fn, t1, inc, m + 1)
                ok = active & ~div & ~turned
                inc = jnp.where(ok, merged, inc)
                return key, inc, m + 1, turned | (ok & mturn)

            key, inc, _, turned = jax.lax.while_loop(
                e_cond, e_body, (key, inc, jnp.int32(1), turned))
            return key, inc, turned

        key, inc, turning_sub = jax.lax.cond(
            pending >= 2, extra_merges, lambda a: a, (key, inc, turned))

        abort = div | turning_sub
        k = c['k'] + 1
        n_leaf = jnp.left_shift(jnp.int32(1), c['depth_s'])
        sub_done = k == n_leaf
        # push the completed frame at its level (= merges performed);
        # the subtree's final frame feeds the main tree directly and lands
        # on the sink level so the write stays one in-place dynamic-update
        w_idx = jnp.where(sub_done, n_lvl, pending)
        stack = jax.lax.dynamic_update_index_in_dim(c['stack'], inc, w_idx,
                                                    axis=0)

        # ---- subtree completion: main-tree doubling bookkeeping, computed
        # UNCONDITIONALLY and gated by the scalar ``sub_done`` broadcast
        # into every lane mask. A ``lax.cond`` here would force
        # pass-through copies of left/right/cur/prop (~30 buffers) every
        # iteration; as masked selects the updates fuse into a few
        # streaming passes instead.
        left, right, p_sum, log_size, prop = (
            c['left'], c['right'], c['p_sum'], c['log_size'], c['prop'])
        go_right, eps, depth, done = (
            c['go_right'], c['eps'], c['depth'], c['done'])

        ok = sub_done & active & ~abort
        sub_ls = inc[L.i_log_size]
        take = ok & (jnp.log(u[1]) < sub_ls - log_size)
        prop = jnp.where(take, inc[L.sl_prop], prop)
        log_size = jnp.where(ok, jnp.logaddexp(log_size, sub_ls), log_size)
        sub_p_sum = inc[L.sl_p_sum]
        p_sum_new = p_sum + sub_p_sum

        # spatial ends: the subtree's integration-order right end is cur
        new_left = _bwhere(go_right, left, cur)
        new_right = _bwhere(go_right, cur, right)

        # main-tree turning checks (``nuts.py:88-101``): six dots packed
        # into one (6, D, C) contraction, halves in spatial order
        inc_left_p = inc[L.sl_left_p]
        inc_left_v = vel_fn(inc_left_p)
        lm_psum = jnp.where(go_right, p_sum, sub_p_sum)
        rm_psum = jnp.where(go_right, sub_p_sum, p_sum)
        lm_begin_v = jnp.where(go_right, left.v, cur.v)
        lm_end_p = jnp.where(go_right, right.p, inc_left_p)
        lm_end_v = jnp.where(go_right, right.v, inc_left_v)
        rm_begin_p = jnp.where(go_right, inc_left_p, left.p)
        rm_begin_v = jnp.where(go_right, inc_left_v, left.v)
        rm_end_v = jnp.where(go_right, cur.v, right.v)
        p_sum1 = lm_psum + rm_begin_p
        p_sum2 = lm_end_p + rm_psum
        lhs = jnp.stack([p_sum_new, p_sum_new, p_sum1, p_sum1,
                         p_sum2, p_sum2], axis=0)
        rhs = jnp.stack([new_left.v, new_right.v, lm_begin_v,
                         rm_begin_v, lm_end_v, rm_end_v], axis=0)
        dots = jnp.sum(lhs * rhs, axis=1)
        turning_full = ((dots[0] <= 0) | (dots[1] <= 0) |
                        (dots[2] <= 0) | (dots[3] <= 0) |
                        (dots[4] <= 0) | (dots[5] <= 0))

        left = _bwhere(ok, new_left, left)
        right = _bwhere(ok, new_right, right)
        p_sum = jnp.where(ok, p_sum_new, p_sum)
        # the aborted extension still counts toward tree_depth, as in the
        # reference where depth increments before the abort check; lanes
        # aborting mid-subtree (divergence / inner U-turn) also count
        depth = jnp.where(active & (sub_done | abort), depth + 1, depth)
        finished = (active & abort) | (ok & (turning_full |
                                             (depth >= max_treedepth)))
        done = done | finished

        # start the next doubling for lanes that completed and continue
        start_next = ok & ~finished
        gr_new = u[2] < 0.5
        go_right = jnp.where(start_next, gr_new, go_right)
        eps = jnp.where(start_next,
                        jnp.where(gr_new, step_size, -step_size),
                        eps).astype(dtype)
        next_end = _bwhere(gr_new, right, left)
        cur = _bwhere(start_next, next_end, cur)

        k = jnp.where(sub_done, 0, k)
        depth_s = jnp.where(sub_done, c['depth_s'] + 1, c['depth_s'])

        return dict(
            key=key, cur=cur, left=left, right=right, prop=prop,
            p_sum=p_sum, log_size=log_size, stack=stack,
            k=k, depth_s=depth_s,
            depth=depth, go_right=go_right, eps=eps,
            accept_sum=accept_sum, n_prop=n_prop, max_de=max_de,
            diverging=diverging, done=done,
            loop_iters=c['loop_iters'] + 1)

    out = jax.lax.while_loop(cond, body, init)
    out = dict(out)
    out['prop'] = L.unflat_prop(out['prop'])
    return out


def nuts_transition_batched(key, q0, metric, step_size, logp_and_grad,
                            max_treedepth, max_change):
    """One full NUTS iteration for all chains at once (``nuts.py:205-217``).

    ``q0`` is (C, D); ``metric`` state leaves may carry a leading chain axis
    or be shared across chains (pooled adaptation); ``step_size`` is (C,) or
    scalar; ``logp_and_grad`` maps (C, D) -> ((C,), (C, D)). All per-lane
    randomness (momenta, multinomial draws, directions) comes from
    counter-based draws of the single ``key``. Internally everything runs
    chain-minor; the (C, D) interface transposes once at entry/exit.
    """
    C, D = q0.shape
    dtype = q0.dtype
    key, k_mom, k_core = jax.random.split(key, 3)
    p0 = sample_momentum_b(metric, k_mom, (C, D), dtype)
    metric_t = _metric_t(metric)
    vel_fn = _make_vel_fn(metric_t)

    def lpg_t(x_t):
        logp, grad = logp_and_grad(x_t.T)
        return logp, grad.T

    start = compute_state_t(metric_t, lpg_t, q0.T, p0.T)
    step_size = jnp.broadcast_to(jnp.asarray(step_size, dtype), (C,))

    step_fn = lambda eps, s: leapfrog_t(metric_t, lpg_t, eps, s)
    prop_of = lambda s: _Proposal(s.q, s.energy, s.logp)
    out = nuts_core_batched(k_core, start, step_fn, prop_of, step_size,
                            max_treedepth, max_change, vel_fn)

    prop = out['prop']
    n_prop_f = jnp.maximum(out['n_prop'], 1).astype(dtype)
    stats = NutsStats(
        logp=prop.logp, energy=prop.energy,
        tree_depth=out['depth'], tree_size=out['n_prop'],
        mean_tree_accept=out['accept_sum'] / n_prop_f,
        energy_change=prop.energy - start.energy,
        max_energy_change=out['max_de'], diverging=out['diverging'])
    return prop.q.T, stats


def nuts_transition(key, q0, metric, step_size, logp_and_grad, max_treedepth,
                    max_change):
    """Single-chain convenience wrapper: batch of one over the batched
    kernel. The multi-chain driver calls ``nuts_transition_batched``
    directly — prefer that (do NOT vmap this wrapper; vmapping a batched
    ``while_loop`` reintroduces the whole-carry select per iteration)."""
    metric_b = jax.tree.map(lambda l: l[None], metric)
    lpg_b = jax.vmap(logp_and_grad)
    q_new, stats = nuts_transition_batched(
        key, q0[None], metric_b, jnp.reshape(step_size, (1,)), lpg_b,
        max_treedepth, max_change)
    return q_new[0], jax.tree.map(lambda l: l[0], stats)
