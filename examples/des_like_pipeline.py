"""DES-Y1-style synthetic pipeline: external likelihood + block surrogate.

Mirrors the structure of the reference's ``examples/des-y1-w-cosmosis.ipynb``
(27 cosmological/nuisance parameters, an expensive external forward model
producing a 457-dim data vector, Gaussian likelihood): here the 'cosmosis'
model is a synthetic host-only numpy function (``traceable=False`` Module —
the real one would be a cosmology pipeline), the surrogate is linear for the
OptimizeStep and linear + quadratic-on-a-9-dim-subset for the SampleSteps
(the reference's cell-18 configuration), and the PostStep runs truncated
importance sampling.

The headline metric is the true-model call count: the reference converges
the full posterior with n_call = 626 (2626 with IS) vs MultiNest's 2.5e5.
"""

import os

import numpy as np
import jax.numpy as jnp

import bayesfast_jax as bf
from bayesfast_jax.modules import PolyConfig, PolyModel, Gaussian

D = 27
N_DATA = 457
NONLINEAR = np.arange(9)  # parameters with quadratic response


def _make_model(seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(N_DATA, D)) / np.sqrt(D)
    B = rng.normal(size=(N_DATA, 9, 9)) / 18.0
    B = (B + np.swapaxes(B, 1, 2)) / 2

    def forward(x, *args, **kwargs):
        """The 'expensive' external model (host-only numpy)."""
        x = np.asarray(x)
        quad = np.einsum('dij,i,j->d', B, x[NONLINEAR], x[NONLINEAR])
        return A @ x + quad

    data = forward(np.zeros(D) + 0.1)
    return forward, data


def main():
    forward, data = _make_model()
    para_range = np.stack([np.full(D, -5.0), np.full(D, 5.0)]).T

    model = bf.Module(fun=forward, input_vars='x', output_vars='m',
                      input_shapes=[D], output_shapes=[N_DATA],
                      traceable=False)
    like = Gaussian(mean=data, cov=np.full(N_DATA, 0.05),
                    input_vars='m', output_vars='logp')
    density = bf.Density(density_name='logp', module_list=[model, like],
                         input_vars='x', input_shapes=[D],
                         input_scales=para_range, hard_bounds=True,
                         decay_options={'use_decay': True})

    surro_0 = PolyModel('linear', input_size=D, output_size=N_DATA,
                        input_vars='x', output_vars='m')
    pc_0 = PolyConfig('linear')
    pc_1 = PolyConfig('quadratic', input_mask=NONLINEAR)
    surro_1 = PolyModel([pc_0, pc_1], input_size=D, output_size=N_DATA,
                        input_vars='x', output_vars='m')

    bf.utils.set_generator(27)
    n_chain = int(os.environ.get('N_CHAIN', 8))
    sample_trace_0 = {'n_chain': n_chain, 'n_iter': 1500, 'n_warmup': 600}
    sample_trace_1 = {'n_chain': n_chain, 'n_iter': 1200, 'n_warmup': 400}

    opt_0 = bf.recipe.OptimizeStep(surrogate_list=surro_0, alpha_n=2,
                                   sample_trace=dict(sample_trace_0))
    sam_0 = bf.recipe.SampleStep(surrogate_list=surro_1, alpha_n=2,
                                 reuse_samples=1,
                                 sample_trace=dict(sample_trace_0))
    sam_1 = bf.recipe.SampleStep(surrogate_list=surro_1, alpha_n=2,
                                 reuse_samples=1,
                                 sample_trace=dict(sample_trace_1))
    pos_0 = bf.recipe.PostStep(n_is=int(os.environ.get('N_IS', 500)),
                               k_trunc=0.25)

    rec = bf.Recipe(density=density, optimize=opt_0, sample=[sam_0, sam_1],
                    post=pos_0)
    rec.run()
    res = rec.get()
    w = res.weights_trunc
    mean_w = np.sum(res.samples * w[:, None], axis=0) / np.sum(w)
    print(f'n_call = {res.n_call} (reference DES run: 2626 incl. IS)')
    print(f'posterior mean (first 5): {np.round(mean_w[:5], 4)} '
          '(true optimum at 0.1)')
    return res


if __name__ == '__main__':
    main()
