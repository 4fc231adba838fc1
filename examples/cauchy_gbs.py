"""48-d bimodal Cauchy + GBS evidence.

Port of ``examples/cauchy-gbs.ipynb`` (fiducial logz = -254.627; published:
-254.636 +- 0.094). Heavy tails + 2^48 modes — the stress test for the
Gaussianizing flow.
"""

import os

import numpy as np
import jax.numpy as jnp

import bayesfast_jax as bf


def main():
    D, a = 48, 5.
    lower = np.full(D, -100.)
    upper = np.full(D, 100.)
    bound = np.stack((lower, upper)).T
    const = float(np.sum(np.log(upper - lower)))

    def logp(x):
        _a = 1 / ((x + a) ** 2 + 1)
        _b = 1 / ((x - a) ** 2 + 1)
        return (jnp.sum(jnp.log(_a + _b)) + D * jnp.log(0.5 / jnp.pi)
                - const)

    bf.utils.set_generator(48)
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
    _rec2('cauchy_gbs', -254.627, res, _time.time() - _t0, sample_trace)
    print(f'logz = {res.logz:.4f} +- {res.logz_err:.4f} '
          '(fiducial: -254.627)')
    return res


if __name__ == '__main__':
    main()
