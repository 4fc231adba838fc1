"""2-d donut with the full surrogate Recipe.

Port of ``examples/2d-donut.ipynb``: the 'expensive' module is m = |x|
(the 2-norm — nearly linear away from the origin, which is what makes the
linear OptimizeStep surrogate work), logp = -(m - 5)^2 / 0.5. Linear
surrogate in the OptimizeStep, quadratic in two SampleSteps; reproduces the
reference's headline call-budget result (n_call ~ 330 true-model
evaluations for a converged posterior at radius 5).
"""

import numpy as np
import jax.numpy as jnp

import bayesfast_jax as bf


def main():
    a, b = 5.0, 0.5

    def f_0(x):
        return jnp.linalg.norm(x, 2, -1)    # the 'expensive' forward model

    def f_1(m):
        return -(m - a) ** 2 / b

    module_0 = bf.Module(fun=f_0, input_vars='x', output_vars='m')
    module_1 = bf.Module(fun=f_1, input_vars='m', output_vars='logp')
    density = bf.Density(module_list=[module_0, module_1], input_shapes=[2],
                         input_vars='x', density_name='logp')
    density.set_decay_options(use_decay=True)

    surro_0 = bf.modules.PolyModel('linear', input_size=2, output_size=1,
                                   input_vars='x', output_vars='m')
    surro_1 = bf.modules.PolyModel('quadratic', input_size=2, output_size=1,
                                   input_vars='x', output_vars='m')
    surro_1.set_bound_options(use_bound=False)

    bf.utils.set_generator(2)
    x_0 = bf.utils.sobol.multivariate_normal([10, 10], np.eye(2), 20)
    sample_trace = {'n_chain': 8, 'n_iter': 1000, 'n_warmup': 500}

    opt = bf.recipe.OptimizeStep(surrogate_list=surro_0, x_0=x_0,
                                 sample_trace=dict(sample_trace))
    sam_0 = bf.recipe.SampleStep(surrogate_list=surro_1, alpha_n=5,
                                 reuse_samples=0,
                                 sample_trace=dict(sample_trace),
                                 logp_cutoff=False)
    sam_1 = bf.recipe.SampleStep(surrogate_list=surro_1, alpha_n=5,
                                 reuse_samples=1,
                                 sample_trace=dict(sample_trace),
                                 logp_cutoff=False)
    rec = bf.Recipe(density=density, optimize=opt, sample=[sam_0, sam_1],
                    post={'n_is': 200})
    rec.run()
    res = rec.get()
    r = np.linalg.norm(res.samples, axis=-1)
    w = res.weights_trunc
    print(f'E[r] = {np.sum(r * w) / np.sum(w):.4f} (target ~{a}), '
          f'n_call = {res.n_call} (reference: ~330)')
    return res


if __name__ == '__main__':
    main()
