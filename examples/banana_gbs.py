"""32-d rotated Banana + GBS evidence.

Port of the reference's ``examples/banana-gbs.ipynb`` (fiducial
logz = -127.364, verified exact in ``examples/BANANA_STUDY.md``; the
reference's published run: -127.276 +- 0.053). The density is written in
JAX — the analytic gradient of the reference collapses into autodiff.

Runs in float64 for evidence parity. The framework's start descent +
reasonable-step probe handle the |logp| ~ 3e6 Sobol cold start in either
dtype, but this density's hard-bounds Q=0.01 geometry is stiff enough
that float32 trajectories pay an O(0.4) acceptance penalty at the float64
step size (float32 remains exact, just ~3x slower-mixing here — see
``tests/test_float32.py`` for the float32 tier). The multi-seed
validation lives in ``examples/banana_study.py``.

Environment knobs: N_CHAIN (default 64), N_ITER (2500), N_WARMUP (1000).
"""

import os

import numpy as np
import jax
jax.config.update('jax_enable_x64', True)
import jax.numpy as jnp
from scipy.stats import special_ortho_group

import bayesfast_jax as bf


def main():
    D, Q = 32, 0.01
    lower = np.full(D, -15.)
    upper = np.full(D, 15.)
    bound = np.stack((lower, upper)).T
    const = float(np.sum(np.log(upper - lower)))
    A = jnp.asarray(special_ortho_group.rvs(D, random_state=0))

    def logp(x):
        x = x @ A.T
        return (-jnp.sum((x[::2] ** 2 - x[1::2]) ** 2 / Q
                         + (x[::2] - 1) ** 2) - const)

    bf.utils.set_generator(32)
    den = bf.DensityLite(logp=logp, input_size=D, input_scales=bound,
                         hard_bounds=True)
    sample_trace = {
        'n_chain': int(os.environ.get('N_CHAIN', 64)),
        'n_iter': int(os.environ.get('N_ITER', 2500)),
        'n_warmup': int(os.environ.get('N_WARMUP', 1000)),
    }
    rec = bf.Recipe(density=den, sample={'sample_trace': sample_trace},
                    post={'evidence_method': 'GBS'})
    import time as _time
    _t0 = _time.time()
    rec.run()
    res = rec.get()
    try:
        from _record import record as _rec2
    except ImportError:
        from examples._record import record as _rec2
    _rec2('banana_gbs', -127.364, res, _time.time() - _t0, sample_trace)
    print(f'logz = {res.logz:.4f} +- {res.logz_err:.4f} '
          '(fiducial: -127.364)')
    return res


if __name__ == '__main__':
    main()
