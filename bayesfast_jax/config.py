"""Global configuration for bayesfast_jax.

The reference implementation (bayesfast) is float64-numpy throughout. Here
every kernel is dtype-polymorphic: the active dtype is float32 unless
``jax_enable_x64`` is on (then float64), with ``set_dtype`` as the single
override. The tests run in float64 on the CPU backend.
"""

import os

import jax
import jax.numpy as jnp

__all__ = ['get_dtype', 'set_dtype', 'asarray', 'default_int',
           'kde_on_device', 'set_kde_device', 'setup_compile_cache']

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_dtype = None  # lazily resolved
_kde_device = None  # None = auto (on whenever an accelerator is attached)


def kde_on_device():
    """Whether bulk KDE-cdf evaluations (the SIT fit inner loop) run on the
    device instead of the host C/OpenMP path. Auto mode turns this on when
    the default backend is an accelerator, where the O(n_x * n_data) sum is
    a batched device reduction rather than a host loop over few cores."""
    if _kde_device is not None:
        return _kde_device
    return jax.default_backend() != 'cpu'


def set_kde_device(mode):
    """Force (True/False) or re-enable auto (None) device KDE-cdf."""
    global _kde_device
    _kde_device = None if mode is None else bool(mode)


def setup_compile_cache():
    """Point JAX's persistent compilation cache at one directory; returns it.

    ``JAX_COMPILATION_CACHE_DIR`` names the directory when it is set;
    otherwise it is the fixed ``.jax_cache`` beside the package (a fixed
    path, because the path is part of what a later run must match to hit).
    Nothing else about the cache is configured here."""
    path = (os.environ.get('JAX_COMPILATION_CACHE_DIR')
            or os.path.join(_REPO, '.jax_cache'))
    jax.config.update('jax_compilation_cache_dir', path)
    return path


def get_dtype():
    """Active floating dtype: float64 iff jax_enable_x64 is on, else float32."""
    global _dtype
    if _dtype is not None:
        return _dtype
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def set_dtype(dtype):
    """Force the framework floating dtype (None to re-derive from jax config).

    Stored as the canonical scalar TYPE (``np.float32``-like, callable),
    not a ``np.dtype`` instance — callers use ``get_dtype()(0)``-style
    construction, and ``set_dtype(get_dtype())`` must round-trip.
    """
    global _dtype
    _dtype = None if dtype is None else jnp.dtype(dtype).type


def asarray(x):
    """Convert to a jnp array of the framework floating dtype."""
    return jnp.asarray(x, dtype=get_dtype())


def default_int():
    return jnp.int32


# ---------------------------------------------------------------------------
# Matmul precision.
#
# Under the default precision XLA may run float32 matmuls at reduced
# precision: on NVIDIA GPUs from Ampere on, as TF32 on the tensor cores
# (10 mantissa bits). For generic NN workloads that is the right trade; for
# Hamiltonian Monte Carlo it is harmful whenever the target density contains
# a matmul (a rotation, a covariance solve, a linear model): the gradient
# noise breaks symplectic energy conservation and the sampler silently
# compensates with a smaller step size.
#
# We therefore default every density/kernel evaluation to
# ``jax_default_matmul_precision='highest'`` at import. The densities this
# framework targets have tiny matmuls (D ~ 10-100), so full float32 matmuls
# cost little next to memory traffic; users running huge traceable models
# can opt back out with ``set_matmul_precision(None)``.
# ---------------------------------------------------------------------------

_prior_matmul_precision = None


def set_matmul_precision(mode='highest'):
    """Set jax's global default matmul precision ('highest' | 'float32' |
    'bfloat16' | ...). ``None`` restores whatever was active before this
    package configured it."""
    global _prior_matmul_precision
    if mode is None:
        jax.config.update('jax_default_matmul_precision',
                          _prior_matmul_precision)
    else:
        jax.config.update('jax_default_matmul_precision', str(mode))


def _configure_matmul_precision():
    global _prior_matmul_precision
    _prior_matmul_precision = jax.config.jax_default_matmul_precision
    if _prior_matmul_precision is None:
        jax.config.update('jax_default_matmul_precision', 'highest')


_configure_matmul_precision()
