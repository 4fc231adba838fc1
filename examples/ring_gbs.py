"""64-d ring + GBS evidence.

Port of ``examples/ring-gbs.ipynb`` (fiducial logz = -114.492; published:
-114.473 +- 0.065).
"""

import os

import numpy as np
import jax.numpy as jnp

import bayesfast_jax as bf


def main():
    D, a, b = 64, 2., 1.
    lower = np.full(D, -5.)
    upper = np.full(D, 5.)
    bound = np.stack((lower, upper)).T
    const = float(np.sum(np.log(upper - lower)))

    def logp(x):
        x2 = x * x
        x2s = jnp.concatenate((x2[-1:], x2, x2[:1]))
        return -jnp.sum((x2s[:-2] + x2s[1:-1] - a) ** 2 / b) - const

    bf.utils.set_generator(64)
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
    _rec2('ring_gbs', -114.492, res, _time.time() - _t0, sample_trace)
    print(f'logz = {res.logz:.4f} +- {res.logz_err:.4f} '
          '(fiducial: -114.492)')
    return res


if __name__ == '__main__':
    main()
