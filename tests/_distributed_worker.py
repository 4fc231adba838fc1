"""Worker process for the multi-process test.

Roles:
  dist <out> <pid> <nproc> <port> — join a jax.distributed cluster of
      ``nproc`` processes x 4 local CPU devices and run the workload on
      the global (2, 4) host-chip mesh; process 0 writes results.
  single <out> — same workload on one process with 8 local devices.
"""

import os
import sys


def main():
    role, out = sys.argv[1], sys.argv[2]
    n_local = 4 if role == 'dist' else 8
    os.environ['XLA_FLAGS'] = (
        os.environ.get('XLA_FLAGS', '')
        + f' --xla_force_host_platform_device_count={n_local}').strip()
    import jax
    jax.config.update('jax_platforms', 'cpu')
    if role == 'dist':
        pid, nproc, port = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
        jax.distributed.initialize(
            coordinator_address=f'127.0.0.1:{port}',
            num_processes=nproc, process_id=pid)
    jax.config.update('jax_enable_x64', True)

    import numpy as np
    import jax.numpy as jnp
    import bayesfast_jax as bf
    from bayesfast_jax.parallel.mesh import make_mesh_2d

    devs = jax.devices()
    assert len(devs) == 8, f'expected 8 global devices, got {devs}'
    mesh = make_mesh_2d(shape=(2, 4), devices=devs)

    D = 3
    den = bf.DensityLite(logp=lambda x: -0.5 * jnp.sum(x ** 2),
                         input_size=D, vectorized=True)

    # per-chain adaptation (no cross-chain collectives): must be bitwise
    bf.utils.set_generator(13)
    tt = bf.sample(den, {'n_chain': 8, 'n_iter': 60, 'n_warmup': 30},
                   verbose=False, mesh=mesh)

    # pooled metric: the Welford reduction is a psum crossing the host
    # (per-process) axis of the mesh
    bf.utils.set_generator(14)
    tt2 = bf.sample(den, {'n_chain': 8, 'n_iter': 40, 'n_warmup': 20,
                          'pooled_metric': True},
                    verbose=False, mesh=mesh)

    if role != 'dist' or jax.process_index() == 0:
        np.savez(out, s=tt.samples, logp=tt.logp, s_pooled=tt2.samples)
    print('WORKER_OK', flush=True)


if __name__ == '__main__':
    main()
