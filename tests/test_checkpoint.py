"""Checkpoint/resume: a saved + reloaded trace continues bit-for-bit
identically to an uninterrupted run (RNG and adaptation state ride in the
carry)."""

import os

import numpy as np
import jax.numpy as jnp

import bayesfast_jax as bf


def _density():
    return bf.DensityLite(logp=lambda x: -0.5 * jnp.sum(x ** 2),
                          input_size=3)


def test_mesh_sharded_save_resume(tmp_path):
    """A trace checkpointed mid-run on the 8-device mesh resumes bitwise —
    both back on the same mesh and with no mesh at all. ``save`` must
    gather the mesh-sharded carry to host numpy for this to work (a pickled
    device array would pin the old sharding)."""
    import jax
    import pickle
    from bayesfast_jax.parallel.mesh import make_mesh

    mesh = make_mesh(jax.devices()[:8])
    den = _density()
    cfg = {'n_chain': 8, 'n_iter': 400, 'n_warmup': 200}

    bf.utils.set_generator(7)
    tt_ref = bf.sample(den, dict(cfg), verbose=False, mesh=mesh)

    bf.utils.set_generator(7)
    tt_half = bf.sample(den, dict(cfg), n_run=250, verbose=False, mesh=mesh)
    path = os.path.join(tmp_path, 'mesh_trace.pkl')
    tt_half.save(path)

    # the pickle must contain no device arrays: loading it in a process
    # with a different topology has to work
    with open(path, 'rb') as f:
        loaded = pickle.load(f)
    carry = loaded.trace._carry
    assert carry is not None
    for leaf in jax.tree.leaves(carry):
        assert not isinstance(leaf, jax.Array), leaf

    # (a) resume on the same mesh
    tt_a = bf.sample(den, bf.TraceTuple.load(path), verbose=False, mesh=mesh)
    assert np.array_equal(tt_ref.samples, tt_a.samples)

    # (b) resume unsharded
    tt_b = bf.sample(den, bf.TraceTuple.load(path), verbose=False, mesh=None)
    assert np.array_equal(tt_ref.samples, tt_b.samples)


def test_trace_resume_bitwise(tmp_path):
    den = _density()

    bf.utils.set_generator(42)
    tt_a = bf.sample(den, {'n_chain': 4, 'n_iter': 600, 'n_warmup': 200},
                     verbose=False)

    bf.utils.set_generator(42)
    tt_b = bf.sample(den, {'n_chain': 4, 'n_iter': 600, 'n_warmup': 200},
                     n_run=300, verbose=False)
    path = os.path.join(tmp_path, 'trace.pkl')
    tt_b.save(path)
    tt_c = bf.TraceTuple.load(path)
    tt_c = bf.sample(den, tt_c, verbose=False)

    assert tt_c.i_iter == 600
    assert np.array_equal(tt_a.samples, tt_c.samples)
    assert np.array_equal(tt_a.logp, tt_c.logp)
