"""Host-side concurrent map for external (non-traceable) likelihoods.

Role in this package: everything traceable runs as one batched device
program, so the reference's process-pool chain parallelism
(``bayesfast/utils/parallel.py:34-204``) has no device-side counterpart here.
What remains host-bound is the *external* true-model path — the DES/cosmosis
pattern where each likelihood call shells out to a foreign pipeline for
seconds at a time (``bayesfast/core/recipe.py:1085-1087`` farms those over a
64-process pool). ``ParallelBackend`` fills that role with two pool kinds:

* ``'threads'`` (default): right when the external model releases the GIL
  (subprocess waits, sockets, BLAS), and the only kind that may touch the
  in-process JAX runtime.
* ``'processes'``: right for pure-Python likelihoods that HOLD the GIL —
  the reference's multiprocess semantics. Workers are forked (spawn
  available via ``mp_context``), the mapped callable and its arguments
  must be picklable (module-level functions, numpy arrays), and worker
  code should not need JAX — the pipeline's external dispatch honors this
  by shipping only the raw user callable plus prepared numpy inputs.
  Workers are pinned to JAX's CPU backend all the same
  (``_pin_worker_to_cpu``), so a callable that does touch ``jnp`` cannot
  open the accelerator, which one process per card already holds.

``set_backend(n)`` fixes the worker count; ``set_backend((n, 'processes'))``
or ``set_backend(ParallelBackend(n, kind='processes'))`` selects the
process pool. ``set_backend(ParallelBackend(serial=True))`` restores a
plain serial map for debugging. An existing ``concurrent.futures`` executor
can also be passed and is used as-is (not shut down on exit).

**Multi-node external likelihoods** (the reference's dask/ray backends,
``parallel.py:34-128``, used for its 64-process DES runs): inject any
``concurrent.futures.Executor`` whose workers live on other nodes —

* dask: ``set_backend(distributed.Client(...).get_executor())`` —
  ``ClientExecutor`` implements the standard Executor interface;
* ray: ``set_backend(RayExecutor())`` for any of the community
  Executor adapters, or wrap ``ray.remote`` calls in a small Executor
  subclass (submit -> ``.remote``, future -> ``ObjectRef`` wrapper);
* MPI: ``set_backend(mpi4py.futures.MPIPoolExecutor(...))``.

Everything the framework ships to workers is a module-level callable plus
numpy arrays (picklable by construction), so any conforming Executor
works; ``tests/test_utils.py::test_injected_executor_backend`` pins the
contract with a mock distributed executor.
"""

import atexit
import multiprocessing
import os
import sys
from concurrent.futures import (Executor, ProcessPoolExecutor,
                                ThreadPoolExecutor)

__all__ = ['ParallelBackend', 'get_backend', 'set_backend']


# Process pools are cached for the life of the interpreter: forkserver
# workers pay a module-import bootstrap on creation (fork workers don't,
# but forking a JAX-initialized parent is unsafe — see ParallelBackend),
# so transient per-map process pools would dominate short external-model
# batches. Keyed by (start method, width); shut down at exit.
_proc_pools = {}


def _shutdown_proc_pools():
    for pool in _proc_pools.values():
        pool.shutdown(wait=False, cancel_futures=True)
    _proc_pools.clear()


atexit.register(_shutdown_proc_pools)


def _pin_worker_to_cpu():
    """Process-pool initializer: keep the worker's JAX (if it ever uses
    one) on the CPU. A JAX process reserves most of an accelerator's memory
    when it first touches it, so a worker that did would starve the
    parent. The preloaded ``jax`` has read its config already, hence the
    explicit update beside the environment variable."""
    os.environ['JAX_PLATFORMS'] = 'cpu'
    jax = sys.modules.get('jax')
    if jax is not None:
        jax.config.update('jax_platforms', 'cpu')


def _shared_proc_pool(mp_context, width):
    key = (mp_context, width)
    pool = _proc_pools.get(key)
    if pool is not None and not getattr(pool, '_broken', False):
        return pool
    ctx = multiprocessing.get_context(mp_context)
    if mp_context == 'forkserver':
        # Preload the heavy scientific stack into the forkserver template
        # (first call wins; no-op once the server runs). Importing jax
        # does NOT start the device runtime — that happens at first
        # backend use — so the template stays fork-safe while workers
        # skip the multi-second imports they would otherwise pay
        # unpickling user callables.
        try:
            ctx.set_forkserver_preload(['numpy', 'jax', 'bayesfast_jax'])
        except Exception:
            pass
    pool = ProcessPoolExecutor(width, mp_context=ctx,
                               initializer=_pin_worker_to_cpu)
    _proc_pools[key] = pool
    return pool


def _is_executor(x):
    """True for concurrent.futures.Executor subclasses AND duck-typed
    executors (dask ClientExecutor, ray adapters): submit() + map()."""
    return (isinstance(x, Executor)
            or (not isinstance(x, (int, ParallelBackend, tuple,
                                   type(None)))
                and hasattr(x, 'submit') and hasattr(x, 'map')))


def _auto_workers(n_items, processes=False):
    """Pool size for the default backend: enough workers to overlap every
    pending external call, capped so pathological batch sizes don't spawn
    thousands of them. Process pools additionally cap at the core count —
    GIL-bound work gains nothing beyond it."""
    n_cpu = os.cpu_count() or 1
    cap = n_cpu if processes else max(32, 4 * n_cpu)
    return max(1, min(n_items, cap))


class ParallelBackend:
    """Concurrent host map with the reference's map/map_async/gather surface.

    Parameters
    ----------
    backend : None, int, Executor or ParallelBackend, optional
        ``None`` (default) uses a transient pool sized to each map call.
        An int pins the pool width. An ``Executor`` is used directly.
    serial : bool, optional
        Force a plain in-order Python map (useful under pdb or when the
        external model is not thread-safe).
    kind : {'threads', 'processes'}, optional
        Pool flavor; defaults to threads. Ignored when an explicit
        ``Executor`` or ``serial=True`` is given.
    mp_context : str, optional
        Multiprocessing start method for ``kind='processes'``; default
        ``'forkserver'`` — forking the main process directly after the
        JAX runtime has started its threads can deadlock a child
        (fork clones only the calling thread; mutexes held by runtime
        threads stay locked forever), whereas the forkserver's template
        process is JAX-free, so its forks are safe and still cheap.
        Pass ``'fork'`` to inherit the parent's imports (only safe
        before any device use) or ``'spawn'`` for maximum isolation.
    """

    def __init__(self, backend=None, serial=False, kind=None,
                 mp_context='forkserver'):
        if isinstance(backend, ParallelBackend):
            serial = serial or backend._serial
            kind = kind or backend._kind
            mp_context = backend._mp_context
            backend = backend._spec
        elif isinstance(backend, tuple) and len(backend) == 2:
            backend, kind = backend
        if not (backend is None or isinstance(backend, int)
                or _is_executor(backend)):
            raise ValueError('backend should be None, an int worker count, '
                             'an Executor (or any object with submit/map), '
                             'or another ParallelBackend.')
        if isinstance(backend, int) and backend <= 0:
            raise ValueError('worker count should be positive.')
        if kind not in (None, 'threads', 'processes'):
            raise ValueError("kind should be 'threads' or 'processes'.")
        self._spec = backend
        self._serial = bool(serial)
        self._kind = kind or 'threads'
        self._mp_context = mp_context
        self._entered = None  # pool owned by an active `with` block

    @property
    def kind(self):
        if self._serial:
            return 'serial'
        if _is_executor(self._spec):
            return 'executor'
        return self._kind

    @property
    def backend(self):
        return self._spec

    def _make_pool(self, width):
        if self._kind == 'processes':
            return _shared_proc_pool(self._mp_context, width)
        return ThreadPoolExecutor(width)

    def _pool_for(self, n_items):
        """(executor, owns_it) for a map over ``n_items`` elements."""
        if self._serial or n_items <= 1:
            return None, False
        if self._entered is not None:
            return self._entered, False
        if _is_executor(self._spec):
            return self._spec, False
        width = self._spec if isinstance(self._spec, int) else \
            _auto_workers(n_items, self._kind == 'processes')
        # shared (cached) process pools are never owned by one map call
        return self._make_pool(width), self._kind != 'processes'

    def __enter__(self):
        # Pre-open a pool so repeated map() calls inside the block reuse it.
        if not self._serial and not _is_executor(self._spec):
            width = self._spec if isinstance(self._spec, int) else \
                _auto_workers(1 << 30, self._kind == 'processes')
            self._entered = self._make_pool(width)
        return self

    def __exit__(self, *exc):
        if self._entered is not None:
            if self._kind != 'processes':  # shared pools persist
                self._entered.shutdown()
            self._entered = None
        return False

    def map(self, fun, *iters):
        jobs = list(zip(*iters))
        pool, owns = self._pool_for(len(jobs))
        if pool is None:
            return [fun(*args) for args in jobs]
        try:
            if self.kind in ('processes', 'executor') or isinstance(
                    pool, ProcessPoolExecutor):
                # process pools and injected (possibly remote) executors
                # need a picklable top-level callable — the lambda wrapper
                # used for threads would fail to pickle
                return list(pool.map(fun, *zip(*jobs)))
            return list(pool.map(lambda args: fun(*args), jobs))
        finally:
            if owns:
                pool.shutdown()

    def map_async(self, fun, *iters):
        jobs = list(zip(*iters))
        pool, owns = self._pool_for(len(jobs))
        if pool is None:
            return [fun(*args) for args in jobs]
        futures = [pool.submit(fun, *args) for args in jobs]
        if owns:
            # transient pool: keep it alive until the futures are gathered
            futures = _OwnedFutures(futures, pool)
        return futures

    def gather(self, async_result):
        if isinstance(async_result, _OwnedFutures):
            try:
                return [f.result() for f in async_result]
            finally:
                async_result.pool.shutdown()
        if async_result and hasattr(async_result[0], 'result'):
            return [f.result() for f in async_result]
        return async_result


class _OwnedFutures(list):
    """Futures plus the transient pool that must outlive them."""

    def __init__(self, futures, pool):
        super().__init__(futures)
        self.pool = pool


_backend = ParallelBackend()


def get_backend():
    return _backend


def set_backend(backend):
    """Replace the global backend: int = fixed thread count, None = auto,
    ``(n, 'processes')`` = fixed process-pool width, or a configured
    ``ParallelBackend``."""
    global _backend
    _backend = ParallelBackend(backend)
