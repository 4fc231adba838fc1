"""Weighted Gaussian-KDE cdf on the device.

The SIT Gaussianization fit evaluates ``cdf(x_i) = sum_k w_k *
Phi((x_i - d_k) / h)`` at every spline knot for every dimension and flow
layer — an O(n_x * n_data) reduction. A naive XLA formulation materializes
the full (n_x, n_data) difference matrix in device memory; both forms here
loop over fixed-size data blocks instead, so the intermediates are
O(n_x * block) and XLA fuses the erf chain into each block's reduction.
"""

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ['kde_cdf_device', 'kde_cdf_batch']

_BLOCK_X = 512
_BLOCK_D = 1024

_SQRT1_2 = 0.7071067811865476


def _phi(z):
    return 0.5 * (1.0 + jax.lax.erf(z * _SQRT1_2))


def _pad_rows(a, m, value):
    n = a.shape[0]
    r = (-n) % m
    if r:
        a = jnp.concatenate([a, jnp.full((r,), value, a.dtype)])
    return a.reshape((-1, m))


@jax.jit
def _cdf_impl(x, data, w, h):
    dtype = x.dtype
    n_x = x.shape[0]
    xp = _pad_rows(x, _BLOCK_X, 0.0)         # (n_xb, BLOCK_X)
    dp = _pad_rows(data, _BLOCK_D, 1e30)     # far pad: Phi(-inf) = 0
    wp = _pad_rows(w, _BLOCK_D, 0.0)

    def body(j, acc):
        z = (xp.reshape(-1)[:, None] - dp[j][None, :]) / h
        return acc + (_phi(z) @ wp[j]).reshape(xp.shape)

    out = jax.lax.fori_loop(0, dp.shape[0], body, jnp.zeros(xp.shape, dtype))
    return out.reshape(-1)[:n_x]


_BLK_N = 1024


@jax.jit
def _cdf_batch_impl(x, data, w, h):
    """Batched-over-columns weighted KDE cdf: ``x`` (D, M) queries,
    ``data`` (D, N) per-column samples (N padded to a block multiple with
    +1e30), ``w`` (N,) shared weights (0 on padding), ``h`` (D,)
    bandwidths. Blocked over N so device memory holds O(D*M*BLK)
    intermediates."""
    D, M = x.shape
    n_blocks = data.shape[1] // _BLK_N

    def body(j, acc):
        d = jax.lax.dynamic_slice_in_dim(data, j * _BLK_N, _BLK_N, axis=1)
        wj = jax.lax.dynamic_slice_in_dim(w, j * _BLK_N, _BLK_N, axis=0)
        z = (x[:, :, None] - d[:, None, :]) / h[:, None, None]
        return acc + jnp.einsum('dmn,n->dm', _phi(z), wj)

    return jax.lax.fori_loop(0, n_blocks, body,
                             jnp.zeros((D, M), x.dtype))


def kde_cdf_batch(x, data, weights, h):
    """Batched KDE cdf across columns; see ``_cdf_batch_impl``. The caller
    pads queries (far positive -> cdf garbage rows it slices off); this
    wrapper pads the data axis.

    When a device mesh is configured (``parallel.mesh.set_mesh``) the data
    axis is sharded over it and each device accumulates the weighted-Phi
    partial sums for its shard, combined with one ``psum`` — the device-mesh
    form of the reference farming SIT per-dim fits over a process pool
    (``bayesfast/transforms/sit.py:230``). The padded data length is rounded
    up to a multiple of (mesh size x block) so every shard sees whole
    blocks; padding rows carry zero weight, preserving exact sums.
    """
    from ..parallel.mesh import get_mesh, mesh_size

    x = jnp.asarray(x)
    data = jnp.asarray(data, x.dtype)
    weights = jnp.asarray(weights, x.dtype)
    h = jnp.asarray(h, x.dtype)
    mesh = get_mesh()
    n_dev = mesh_size(mesh)
    blk = _BLK_N * n_dev if n_dev > 1 else _BLK_N
    pad = (-data.shape[1]) % blk
    if pad:
        data = jnp.concatenate(
            [data, jnp.full((data.shape[0], pad), 1e30, data.dtype)], axis=1)
        weights = jnp.concatenate(
            [weights, jnp.zeros((pad,), weights.dtype)])
    if n_dev > 1:
        from jax.sharding import PartitionSpec as P
        axes = tuple(mesh.axis_names)

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(), P(None, axes), P(axes), P()),
                 out_specs=P(), check_vma=False)
        def sharded(xq, d, w, hh):
            part = _cdf_batch_impl(xq, d, w, hh)
            for ax in axes:
                part = jax.lax.psum(part, ax)
            return part

        return sharded(x, data, weights, h)
    return _cdf_batch_impl(x, data, weights, h)


def kde_cdf_device(x, data, weights, h):
    """Weighted 1-d KDE cdf on device; shapes (n_x,), (n_data,), (n_data,).

    Blocked over the data axis, so device memory holds O(n_x * block)
    intermediates whatever ``n_data`` is."""
    x = jnp.asarray(x)
    data = jnp.asarray(data, x.dtype)
    weights = jnp.asarray(weights, x.dtype)
    h = jnp.asarray(h, x.dtype)
    return _cdf_impl(x, data, weights, h)
