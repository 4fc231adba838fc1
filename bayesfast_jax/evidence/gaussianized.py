"""Gaussianized evidence estimators: GBS / GIS / GHM.

Behavioral parity target: ``bayesfast/evidence/gaussianized.py`` (GBS at
:179, GIS at :218, GHM at :236). Each estimator fits a SIT normalizing flow
to posterior samples and combines the flow's tractable density q with the
target p: GBS bridges between q-draws and held-out chains, GIS importance-
samples q-draws, GHM harmonic-means held-out chains. The reference evaluates
logp over a process pool (``gaussianized.py:171-176``); here those are single
batched device (or thread-pooled host) calls.
"""

import warnings

import numpy as np

from .bridge import bridge
from .importance import importance
from .harmonic import harmonic
from ..transforms import SIT
from ..samplers import TraceTuple

__all__ = ['GBS', 'GIS', 'GHM']


def _as_chain_array(x_p):
    """Coerce x_p to a (chain, iter, dim) or (iter, dim) sample array,
    also returning the trace's exact call count when one is available."""
    n_call = None
    if isinstance(x_p, TraceTuple):
        n_call = x_p.n_call
        x_p = x_p.get(flatten=False)
    else:
        x_p = np.asarray(x_p)
        if not 2 <= x_p.ndim <= 3:
            raise ValueError('x_p should be a TraceTuple or an array with '
                             '2 or 3 dims (chains x iters x dim).')
    if x_p.shape[-1] <= 1 or np.prod(x_p.shape[:-1]) <= 1:
        raise ValueError('x_p needs more than one sample and more than one '
                         'dimension.')
    if x_p.shape[0] == 1:
        x_p = x_p[0]  # collapse a singleton chain axis
    return x_p, n_call


def _batched_logp(logp, x):
    """Evaluate a logp callable over any leading shape in one batched call.

    With a device mesh configured the flattened batch is sharded over it
    before the call (the device-mesh form of the reference pool-mapping
    proposal logp evaluations, ``gaussianized.py:171-176``); sharding
    propagates through the density's jitted batch evaluator.
    """
    from ..parallel.mesh import get_mesh, shard_batch

    lead = x.shape[:-1]
    flat = x.reshape((-1, x.shape[-1]))
    if get_mesh() is not None:
        # only convert to a device array when sharding applies — host-side
        # logp callables (external likelihoods) keep receiving numpy
        import jax.numpy as jnp
        flat = shard_batch(jnp.asarray(flat))
    out = np.asarray(logp(flat))
    return out.reshape(lead)


def _split_or_recompute_logp_p(logp, x_p, logp_p, n_half):
    """Use caller-supplied logp_p values for the held-out half when their
    shape matches; otherwise recompute them."""
    if logp_p is not None:
        logp_p = np.asarray(logp_p)
        if logp_p.shape == x_p.shape[:-1]:
            return logp_p[n_half:]
        warnings.warn('ignoring logp_p: its shape does not match x_p; '
                      'recomputing from the logp callable.', RuntimeWarning)
    return _batched_logp(logp, x_p[n_half:])


class _SITEstimator:
    """Common SIT-flow plumbing for the three estimators."""

    def __init__(self, sit=None, parallel_backend=None):
        if sit is None or isinstance(sit, dict):
            sit = SIT(**(sit or {}))
        elif not isinstance(sit, SIT):
            raise ValueError('sit should be None, an options dict, or a SIT '
                             'instance.')
        self._sit = sit
        # reference-API compatibility; logp batches run on device here
        self._parallel_backend = parallel_backend

    @property
    def sit(self):
        return self._sit

    def run(self, x_p, logp, logp_p=None):
        raise NotImplementedError('abstract method.')

    def __call__(self, *args, **kwargs):
        return self.run(*args, **kwargs)


class _ProposalSized(_SITEstimator):
    """Adds the proposal-count policy shared by GBS and GIS: n_q explicit,
    or f_call x the trace's true-model call count (reference
    ``gaussianized.py:135-154``), optionally capped."""

    def __init__(self, sit=None, parallel_backend=None, n_q=None,
                 f_call=0.05, n_q_max=None):
        super().__init__(sit, parallel_backend)
        if n_q is not None:
            n_q = int(n_q)
            if n_q <= 0:
                raise ValueError('n_q should be a positive int or None.')
        self._n_q = n_q
        if f_call is not None:
            f_call = float(f_call)
            if f_call <= 0:
                raise ValueError('f_call should be a positive float or '
                                 'None.')
        self._f_call = f_call
        # massively parallel chains make f_call x n_call explode; the cap is
        # an extension (None reproduces reference sizing exactly)
        if n_q_max is not None:
            n_q_max = int(n_q_max)
            if n_q_max <= 0:
                raise ValueError('n_q_max should be a positive int or None.')
        self.n_q_max = n_q_max

    n_q = property(lambda self: self._n_q)
    f_call = property(lambda self: self._f_call)

    def _proposal_count(self, x_p, n_call):
        if self._n_q is not None:
            n_q = self._n_q
        elif self._f_call is not None and n_call is not None:
            n_q = int(n_call * self._f_call)
        else:
            if self._f_call is not None:
                warnings.warn('f_call sizing needs a TraceTuple (for its '
                              'call count); matching the posterior sample '
                              'count instead.', RuntimeWarning)
            n_q = int(np.prod(x_p.shape[:-1]))
        if self.n_q_max is not None:
            n_q = min(n_q, self.n_q_max)
        return n_q

    def run(self, x_p, logp, logp_p=None):
        if not callable(logp):
            raise ValueError('logp should be callable.')
        x_p, n_call = _as_chain_array(x_p)
        return self._estimate(logp, x_p, logp_p,
                              self._proposal_count(x_p, n_call))

    def _estimate(self, logp, x_p, logp_p, n_q):
        raise NotImplementedError('abstract method.')


class GBS(_ProposalSized):
    """Gaussianized Bridge Sampling (reference ``gaussianized.py:179-215``):
    fit the flow on the first half of the chains, bridge between n_q flow
    draws and the held-out half."""

    def _estimate(self, logp, x_p, logp_p, n_q):
        import time as _time
        prof = {}
        n_half = x_p.shape[0] // 2
        t0 = _time.time()
        self.sit.fit(data=x_p[:n_half])
        prof['sit_fit_s'] = round(_time.time() - t0, 2)
        t0 = _time.time()
        x_q = self.sit.sample(n_q)[0]
        prof['flow_sample_s'] = round(_time.time() - t0, 2)

        t0 = _time.time()
        logp_p = _split_or_recompute_logp_p(logp, x_p, logp_p, n_half)
        logp_q = _batched_logp(logp, x_q)
        prof['logp_batches_s'] = round(_time.time() - t0, 2)
        t0 = _time.time()
        logq_p = self.sit.logq(x_p[n_half:])
        logq_q = self.sit.logq(x_q)
        prof['flow_logq_s'] = round(_time.time() - t0, 2)
        t0 = _time.time()
        out = bridge(logp_p, logp_q, logq_p, logq_q)
        prof['bridge_s'] = round(_time.time() - t0, 2)
        # per-phase wall profile of the last run, for perf triage (which
        # phase dominates the GBS wall)
        self.last_profile = prof
        return out


class GIS(_ProposalSized):
    """Gaussianized Importance Sampling (reference
    ``gaussianized.py:218-233``): fit the flow on all samples, importance-
    sample n_q flow draws."""

    def _estimate(self, logp, x_p, logp_p, n_q):
        self.sit.fit(data=x_p)
        x_q = self.sit.sample(n_q)[0]
        return importance(_batched_logp(logp, x_q), self.sit.logq(x_q))


class GHM(_SITEstimator):
    """Gaussianized Harmonic Mean (reference ``gaussianized.py:236-286``):
    fit the flow on the first half of the chains, harmonic-mean the held-out
    half (no proposal draws, so logp may be omitted when logp_p is given)."""

    def run(self, x_p, logp=None, logp_p=None):
        x_p, _ = _as_chain_array(x_p)
        n_half = x_p.shape[0] // 2

        if logp_p is not None:
            logp_p = np.asarray(logp_p)
            if logp_p.shape == x_p.shape[:-1]:
                logp_p = logp_p[n_half:]
            else:
                warnings.warn('ignoring logp_p: its shape does not match '
                              'x_p; recomputing from the logp callable.',
                              RuntimeWarning)
                logp_p = None
        if logp_p is None:
            if not callable(logp):
                raise ValueError('GHM needs either matching logp_p values '
                                 'or a callable logp.')
            logp_p = _batched_logp(logp, x_p[n_half:])

        self.sit.fit(data=x_p[:n_half])
        return harmonic(logp_p, self.sit.logq(x_p[n_half:]))
