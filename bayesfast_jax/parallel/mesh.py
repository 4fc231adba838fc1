"""Device-mesh helpers: the device-mesh 'parallel backend'.

The reference parallelizes chains over a process pool
(``bayesfast/utils/parallel.py:34-204``: multiprocess/ray/dask/loky). Here the
chain axis is a sharded array axis over a ``jax.sharding.Mesh``: one jitted
program runs all chains, XLA partitions the batched transition across devices
(the cards of one node, and the nodes of a multi-process run), and
cross-chain reductions are on-device collectives (NCCL on GPUs) instead of
driver-side gathers. The cards of one node reach each other all to all, so
a node needs only the 1-d ``make_mesh``.
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ['get_mesh', 'set_mesh', 'make_mesh', 'make_mesh_2d',
           'shard_chains', 'chain_sharding', 'shard_batch', 'mesh_size']

_mesh = None

CHAIN_AXIS = 'chain'


def make_mesh(devices=None, axis_name=CHAIN_AXIS):
    """Build a 1-d chain mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh_2d(shape=None, devices=None, axis_names=('host', 'chip')):
    """Build a (node, card)-shaped 2-axis mesh (axis names ``host``,
    ``chip``).

    This is the layout for multi-node runs: the outer axis has one row per
    node (process), the inner axis the cards of that node, joined by the
    node's own fast links. Chain-sharded arrays split over *both* axes (see
    ``chain_sharding``), so chain collectives reduce within each node first
    and cross the slower inter-node network once per node — XLA lowers the
    psum hierarchically from the mesh axis order. With ``shape=None`` the
    devices are arranged (n_nodes, cards_per_node) from their process index.
    """
    if devices is None:
        devices = jax.devices()
    if shape is None:
        n_proc = max(getattr(d, 'process_index', 0) for d in devices) + 1
        shape = (n_proc, len(devices) // n_proc)
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, tuple(axis_names))


def set_mesh(mesh):
    """Set (or clear, with None) the global default mesh for sampling."""
    global _mesh
    _mesh = mesh


def get_mesh():
    return _mesh


def mesh_size(mesh=None):
    """Total device count of the given (or global) mesh; 0 when unset."""
    if mesh is None:
        mesh = _mesh
    if mesh is None:
        return 0
    return int(np.prod(list(mesh.shape.values())))


def chain_sharding(mesh=None):
    """NamedSharding that splits the leading (chain) axis over the mesh.

    For multi-axis meshes the chain axis splits over all axes (outer
    first), so a (node, card) mesh shards chains hierarchically."""
    if mesh is None:
        mesh = _mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, P(tuple(mesh.axis_names)))


def shard_batch(x, mesh=None, axis=0):
    """device_put one array with dimension ``axis`` split over the mesh.

    The evidence-phase analog of ``shard_chains``: proposal batches, flow
    evaluation batches and KDE data axes shard over the same mesh the
    sampler uses. No-op without a mesh or when the axis size does not
    divide the device count (XLA would need padding; callers keep exact
    semantics instead).
    """
    if mesh is None:
        mesh = _mesh
    if mesh is None:
        return x
    n_dev = mesh_size(mesh)
    if n_dev <= 1 or x.shape[axis] % n_dev != 0:
        return x
    spec = [None] * getattr(x, 'ndim', 1)
    spec[axis] = tuple(mesh.axis_names)
    return jax.device_put(x, NamedSharding(mesh, P(*spec)))


def shard_chains(tree, n_chain, mesh=None):
    """device_put a chain-batched pytree with the chain axis sharded.

    No-op when no mesh is configured or ``n_chain`` doesn't divide the mesh
    size (XLA would require padding; we fall back to replication-free default
    placement instead).
    """
    if mesh is None:
        mesh = _mesh
    if mesh is None:
        return tree
    n_dev = int(np.prod(list(mesh.shape.values())))
    if n_chain % n_dev != 0:
        return tree
    sharding = chain_sharding(mesh)
    replicated = NamedSharding(mesh, P())

    def put(x):
        # shard only chain-batched leaves; replicate shared state (e.g. the
        # pooled mass matrix)
        if getattr(x, 'ndim', 0) >= 1 and x.shape[0] == n_chain:
            return jax.device_put(x, sharding)
        return jax.device_put(x, replicated)

    return jax.tree.map(put, tree)
