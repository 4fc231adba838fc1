"""Sobol quasi-Monte-Carlo sequence, vectorized for the device.

Replaces the reference's sequential Cython generator
(``bayesfast/utils/_sobol.pyx:71-150``, itself a port of Joe & Kuo's
``sobol.cc``). Two changes for a batched device program:

1. The per-dimension direction numbers are precomputed on host into a dense
   ``(d, 32)`` uint32 matrix ``V`` (vectorized over dimensions, grouped by
   polynomial degree), from the public-domain Joe-Kuo (2008) table
   (https://web.maths.unsw.edu.au/~fkuo/sobol/, BSD licence), shipped here in
   compact binary form (``joe_kuo_6.npz``, 21201 dimensions).
2. The sequential XOR recurrence ``X_i = X_{i-1} ^ V[c(i-1)]`` is replaced by
   the equivalent closed form over the Gray code ``g(i) = i ^ (i >> 1)``:
   ``X_i = XOR_{b: bit b of g(i)} V[b]`` — 32 fully-parallel masked XORs
   instead of a length-N scan.

API mirrors ``bayesfast/utils/sobol.py:12-60``: ``uniform`` and
``multivariate_normal`` (eigh-factor scaling of ``ndtri``-mapped points).
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import get_dtype

__all__ = ['uniform', 'multivariate_normal', 'sobol_uint32', 'direction_numbers']

_TABLE_PATH = os.path.join(os.path.dirname(__file__), 'joe_kuo_6.npz')
_table = None
_V_cache = {}  # d -> np.ndarray (d, 32) uint32
_MAX_BITS = 32


def _load_table():
    global _table
    if _table is None:
        _table = np.load(_TABLE_PATH)
    return _table


def direction_numbers(d):
    """Dense direction-number matrix ``V`` of shape ``(d, 32)`` (uint32).

    ``V[j, b]`` is the direction number of dimension ``j`` for bit ``b``
    (scaled by 2^32). Dimension 0 is the van-der-Corput radix-2 sequence
    (all m = 1); higher dimensions come from the Joe-Kuo table with the
    primitive-polynomial recurrence.
    """
    d = int(d)
    for cached_d in _V_cache:
        if cached_d >= d:
            return _V_cache[cached_d][:d]
    tab = _load_table()
    s_all, a_all, m_all, off = tab['s'], tab['a'], tab['m'], tab['off']
    if d - 1 > len(s_all):
        raise NotImplementedError(
            f'd = {d} is not supported: direction table has '
            f'{len(s_all) + 1} dimensions.')
    V = np.zeros((d, _MAX_BITS), dtype=np.uint32)
    # dimension 0: m_i = 1 for all i
    V[0] = np.uint32(1) << (np.uint32(31) - np.arange(_MAX_BITS, dtype=np.uint32))
    if d > 1:
        s = s_all[:d - 1].astype(np.int64)
        a = a_all[:d - 1].astype(np.uint32)
        # group dimensions by s so the recurrence vectorizes across the group
        for sv in np.unique(s):
            idx = np.nonzero(s == sv)[0]
            sv = int(sv)
            m = np.zeros((len(idx), sv), dtype=np.uint32)
            for row, j in enumerate(idx):
                o = int(off[j])
                m[row] = m_all[o:o + sv]
            Vg = np.zeros((len(idx), _MAX_BITS), dtype=np.uint32)
            ncopy = min(sv, _MAX_BITS)
            shifts = (np.uint32(32) - np.arange(1, ncopy + 1, dtype=np.uint32))
            Vg[:, :ncopy] = m[:, :ncopy] << shifts[None, :]
            ag = a[idx]
            for i in range(sv, _MAX_BITS):  # i is 0-based bit index = level i+1
                v = Vg[:, i - sv] ^ (Vg[:, i - sv] >> np.uint32(sv))
                for k in range(1, sv):
                    bit = (ag >> np.uint32(sv - 1 - k)) & np.uint32(1)
                    v ^= bit * Vg[:, i - k]
                Vg[:, i] = v
            V[idx + 1] = Vg
    _V_cache.clear()
    _V_cache[d] = V
    return V


@partial(jax.jit, static_argnames=('n',))
def _sobol_kernel(V, i0, n):
    """Gray-code Sobol integers for indices ``i0 .. i0+n-1``; shape (n, d)."""
    i = jnp.arange(n, dtype=jnp.uint32) + i0.astype(jnp.uint32)
    g = i ^ (i >> jnp.uint32(1))

    def body(b, X):
        mask = ((g >> jnp.uint32(b)) & jnp.uint32(1)).astype(jnp.uint32)
        return X ^ (mask[:, None] * V[None, :, b])

    X = jnp.zeros((n, V.shape[0]), dtype=jnp.uint32)
    return jax.lax.fori_loop(0, _MAX_BITS, body, X)


def sobol_uint32(n, d, skip=0):
    """Raw Sobol integers (scaled by 2^32) as a device array of shape (n, d)."""
    V = jnp.asarray(direction_numbers(d))
    return _sobol_kernel(V, jnp.uint32(skip), int(n))


def uniform(low, high, size, skip=1):
    """Sobol points rescaled to ``[low, high)``; shape ``(size, d)``.

    Mirrors ``bayesfast.utils.sobol.uniform`` (``utils/sobol.py:12-46``):
    the first ``skip`` points of the sequence (including the all-zero point 0)
    are dropped by default.
    """
    low = np.atleast_1d(low)
    high = np.atleast_1d(high)
    if not (low.ndim == 1 and low.shape == high.shape):
        raise ValueError('low and high should be 1-d arrays with the same '
                         f'shape, got {low.shape} and {high.shape}.')
    d = low.shape[0]
    size = int(size)
    skip = int(skip)
    if size <= 0:
        raise ValueError(f'size should be a positive int, instead of {size}.')
    if skip < 0:
        raise ValueError(f'skip should be a non-negative int, instead of {skip}.')
    dtype = get_dtype()
    X = sobol_uint32(size, d, skip)
    pts = X.astype(jnp.float64 if dtype == jnp.float64 else jnp.float32)
    pts = pts * (2.0 ** -32)
    pts = jnp.asarray(low, dtype) + jnp.asarray(high - low, dtype) * pts
    return np.asarray(pts)


def multivariate_normal(mean, cov, size, skip=1, chunk=1 << 18):
    """Sobol-QMC multivariate normal draws (``utils/sobol.py:49-60``).

    Draws are produced in chunks of at most ``chunk`` points (the Sobol
    sequence continues across chunks via ``skip``), so evidence-phase
    requests of millions of proposal points stay memory-bounded on device.
    """
    mean = np.atleast_1d(mean)
    cov = np.atleast_2d(cov)
    d = mean.shape[0]
    if not (mean.shape == (d,) and cov.shape == (d, d)):
        raise ValueError('the shape of mean is not consistent with the shape '
                         'of cov.')
    size = int(size)
    a, w = np.linalg.eigh(np.asarray(cov, np.float64))
    a = np.clip(a, 0.0, None)
    out = np.empty((size, d), np.asarray(get_dtype()(0)).dtype)
    for off in range(0, size, chunk):
        n = min(chunk, size - off)
        pts = jnp.asarray(uniform(np.zeros(d), np.ones(d), n, skip + off))
        z = jax.scipy.special.ndtri(pts)
        res = jnp.asarray(mean, z.dtype) + \
            (z * jnp.asarray(a ** 0.5, z.dtype)) @ jnp.asarray(w.T, z.dtype)
        out[off:off + n] = np.asarray(res)
    return out
