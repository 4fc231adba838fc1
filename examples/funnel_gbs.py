"""16-d Neal funnel + GBS evidence.

Port of ``examples/funnel-gbs.ipynb`` (fiducial logz = -63.4988; published:
-63.479 +- 0.017). Uses target_accept=0.95 for the pathological neck.
"""

import os

import numpy as np
import jax.numpy as jnp

import bayesfast_jax as bf


def main():
    D, a, b = 16, 1., 0.5
    lower = np.full(D, -30.)
    upper = np.full(D, 30.)
    lower[0], upper[0] = -4, 4
    bound = np.stack((lower, upper)).T
    const = float(np.sum(np.log(upper - lower)))

    def logp(x):
        n = D
        _a = -0.5 * x[0] ** 2 / a ** 2
        _b = -0.5 * jnp.sum(x[1:] ** 2) * jnp.exp(-2 * b * x[0])
        _c = (-0.5 * jnp.log(2 * jnp.pi * a ** 2)
              - 0.5 * (n - 1) * jnp.log(2 * jnp.pi) - (n - 1) * b * x[0])
        return _a + _b + _c - const

    bf.utils.set_generator(16)
    den = bf.DensityLite(logp=logp, input_size=D, input_scales=bound,
                         hard_bounds=True)
    sample_trace = {
        'n_chain': int(os.environ.get('N_CHAIN', 64)),
        'n_iter': int(os.environ.get('N_ITER', 2500)),
        'n_warmup': int(os.environ.get('N_WARMUP', 1000)),
        'target_accept': 0.95,
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
    _rec2('funnel_gbs', -63.4988, res, _time.time() - _t0, sample_trace)
    print(f'logz = {res.logz:.4f} +- {res.logz_err:.4f} '
          '(fiducial: -63.4988)')
    return res


if __name__ == '__main__':
    main()
