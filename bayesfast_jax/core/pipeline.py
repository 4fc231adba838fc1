"""Module-graph pipelines and graph densities.

Counterpart of ``bayesfast/core/density.py:205-838``. The reference walks the
module list in Python per sample, threading hand-written Jacobians
(``output_jac @ input_jac``); here the walk happens once at trace time — the
whole graph (constraint transform + modules + surrogate substitution +
log-Jacobian corrections) compiles into a single XLA program, gradients come
from one reverse-mode pass, and batching is ``vmap`` instead of per-row
recursion (``density.py:413-439``).

Surrogate substitution (``use_surrogate``) and ``original_space`` are *static*
compilation variants: each flag combination traces its own program, matching
the reference's call-time graph switch (``density.py:442-463``) without
runtime branching.
"""

from collections import OrderedDict

import numpy as np
import jax
import jax.numpy as jnp

from ..config import get_dtype
from ..ops import constraint as _con
from ..utils.collections import VariableDict, PropertyList
from ..utils import all_isinstance
from .module import ModuleBase, Surrogate
from .density import _PipelineBase, _DensityBase

__all__ = ['Pipeline', 'Density']


class Pipeline(_PipelineBase):
    """Composite function over named variables (``density.py:205-614``)."""

    def __init__(self, module_list=(), surrogate_list=(),
                 input_vars='__var__', input_shapes=None, input_scales=None,
                 hard_bounds=False, copy_input=False, module_start=None,
                 module_stop=None, original_space=True, use_surrogate=False):
        self.module_list = module_list
        self.surrogate_list = surrogate_list
        self.input_vars = input_vars
        self.input_shapes = input_shapes
        self.input_scales = input_scales
        self.hard_bounds = hard_bounds
        self.module_start = module_start
        self.module_stop = module_stop
        self.original_space = original_space
        self.use_surrogate = use_surrogate

    # ------------- list plumbing -------------

    @property
    def module_list(self):
        return self._module_list

    @module_list.setter
    def module_list(self, ml):
        if isinstance(ml, ModuleBase):
            ml = [ml]
        if not hasattr(ml, '__iter__'):
            raise ValueError('invalid value for module_list.')
        self._module_list = PropertyList(ml, self._ml_check)

    @staticmethod
    def _ml_check(ml):
        for i, m in enumerate(ml):
            if not isinstance(m, ModuleBase):
                raise ValueError(f'element #{i} of module_list is not a '
                                 'subclass object of ModuleBase.')
        return ml

    @property
    def surrogate_list(self):
        return self._surrogate_list

    @surrogate_list.setter
    def surrogate_list(self, sl):
        if isinstance(sl, Surrogate):
            sl = [sl]
        if not hasattr(sl, '__iter__'):
            raise ValueError('surrogate_list should be a Surrogate, or '
                             'consist of Surrogate(s).')
        self._surrogate_list = PropertyList(sl, self._sl_check)

    def _sl_check(self, sl):
        for i, s in enumerate(sl):
            if not isinstance(s, Surrogate):
                raise ValueError(f'element #{i} of surrogate_list is not a '
                                 'Surrogate')
        self._build_surrogate_recipe(sl)
        return sl

    def _build_surrogate_recipe(self, sl):
        """Sorted, overlap-checked (index, i_step, n_step) table
        (``density.py:314-330``)."""
        ns = len(sl)
        if ns > 0:
            recipe = np.array([[i, *s._scope] for i, s in enumerate(sl)])
            order = np.argsort(recipe[:, 1] % max(self.n_module, 1))
            recipe = recipe[order].astype(int)
            for i in range(ns - 1):
                if np.sum(recipe[i, 1:]) > recipe[i + 1, 1]:
                    raise ValueError(f'the #{i} surrogate model overlaps with '
                                     'the next one.')
            self._surrogate_recipe = recipe
        else:
            self._surrogate_recipe = np.empty((0, 3), dtype=int)

    @property
    def n_module(self):
        return len(self._module_list)

    @property
    def n_surrogate(self):
        return len(self._surrogate_list)

    @property
    def has_surrogate(self):
        return self.n_surrogate > 0

    @property
    def module_start(self):
        return self._module_start

    @module_start.setter
    def module_start(self, start):
        self._module_start = None if start is None else int(start)

    @property
    def module_stop(self):
        return self._module_stop

    @module_stop.setter
    def module_stop(self, stop):
        self._module_stop = None if stop is None else int(stop)

    @property
    def use_surrogate(self):
        return self._use_surrogate

    @use_surrogate.setter
    def use_surrogate(self, us):
        self._use_surrogate = bool(us)

    @property
    def input_vars(self):
        return self._input_vars

    @input_vars.setter
    def input_vars(self, names):
        self._input_vars = PropertyList(
            names, lambda x: ModuleBase._var_check(x, 'input', 'raise', 1,
                                                   np.inf))

    @property
    def input_shapes(self):
        return self._input_shapes

    @input_shapes.setter
    def input_shapes(self, shapes):
        if shapes is None:
            self._input_shapes = None
            self._input_cum = None
        else:
            shapes = np.atleast_1d(shapes).astype(int)
            if not (shapes.size > 0 and shapes.ndim == 1 and
                    np.all(shapes > 0)):
                raise ValueError('input_shapes should be a 1-d array_like of '
                                 'positive int(s), or None.')
            self._input_shapes = shapes
            self._input_cum = np.cumsum(np.insert(shapes, 0, 0))

    @property
    def input_size(self):
        return None if self._input_shapes is None else int(
            np.sum(self._input_shapes))

    # ------------- evaluation plan -------------

    def _get_start_stop(self):
        start = 0 if self._module_start is None else (
            self._module_start % self.n_module)
        stop = (self.n_module - 1 if self._module_stop is None else
                self._module_stop % self.n_module)
        if start > stop:
            raise ValueError('start should be no larger than stop.')
        return start, stop

    def _plan(self, use_surrogate):
        """Static execution plan: list of (module, params_ref) with surrogate
        substitution applied (``density.py:442-463``)."""
        start, stop = self._get_start_stop()
        plan = []
        si = 0
        us = use_surrogate and self.has_surrogate
        if us:
            si = int(np.searchsorted(self._surrogate_recipe[:, 1], start))
            if si == self.n_surrogate:
                us = False
        i = start
        while i <= stop:
            if us and i == self._surrogate_recipe[si, 1]:
                idx = self._surrogate_recipe[si, 0]
                plan.append(('surrogate', idx))
                i += int(self._surrogate_recipe[si, 2])
                if si == self.n_surrogate - 1:
                    us = False
                else:
                    si += 1
            else:
                plan.append(('module', i))
                i += 1
        return plan

    def _module_by_ref(self, kind, idx):
        return (self._surrogate_list[idx] if kind == 'surrogate'
                else self._module_list[idx])

    def current_params(self):
        """Dynamic parameter pytree for all modules + surrogates."""
        return {
            'modules': tuple(m.dynamic_params() for m in self._module_list),
            'surrogates': tuple(s.dynamic_params()
                                for s in self._surrogate_list),
        }

    def _seed_vars(self, x):
        d = OrderedDict()
        if self._input_cum is None:
            d[self._input_vars[0]] = x
        else:
            for i, n in enumerate(self._input_vars):
                d[n] = x[self._input_cum[i]:self._input_cum[i + 1]]
        return d

    def _seed_point(self, x, original_space):
        """Transform one input point and seed the named-variable dict."""
        x = jnp.asarray(x, get_dtype())
        if not original_space:
            x = self._to_original_j(x)
        return self._seed_vars(x)

    def _eval_vars(self, x, params, original_space, use_surrogate):
        """Traced single-point evaluation to a dict of jnp arrays."""
        d = self._seed_point(x, original_space)
        for kind, idx in self._plan(use_surrogate):
            module = self._module_by_ref(kind, idx)
            p = params[kind + 's'][idx] if params is not None else None
            inputs = [d[n] for n in module.input_vars]
            outputs = module._call_traced(inputs, p)
            for n, o in zip(module.output_vars, outputs):
                d[n] = o
            for n in module._delete_vars:
                del d[n]
        return d

    # ------------- host-facing API -------------

    def _has_external(self, use_surrogate):
        """True if the active plan contains non-traceable (host) modules."""
        return any(not self._module_by_ref(kind, idx).traceable
                   for kind, idx in self._plan(use_surrogate))

    def _vmapped_eval(self, x, original_space, use_surrogate):
        params = self.current_params()
        x = jnp.asarray(x, get_dtype())
        single = lambda xi: self._eval_vars(xi, params, original_space,
                                            use_surrogate)
        if x.ndim == 1:
            return single(x), False
        flat = x.reshape((-1, x.shape[-1]))
        if self._has_external(use_surrogate):
            # staged execution: traceable stages run as ONE vmapped device
            # call over the whole batch, each external stage fans its rows
            # out over the ParallelBackend pool (threads for GIL-releasing
            # models, processes for pure-Python ones — the reference's
            # 64-process DES pattern, ``recipe.py:1085-1087``), outside
            # the jitted program rather than as a pure_callback under vmap.
            from ..utils.parallel import get_backend
            backend = get_backend()
            n_rows = int(flat.shape[0])
            d = jax.vmap(lambda xi: self._seed_point(xi, original_space))(
                flat)
            for kind, idx in self._plan(use_surrogate):
                module = self._module_by_ref(kind, idx)
                p = params[kind + 's'][idx] if params is not None else None
                inputs = [d[n] for n in module.input_vars]
                if module.traceable:
                    outputs = jax.vmap(
                        lambda *ins, _m=module, _p=p:
                        _m._call_traced(list(ins), _p))(*inputs)
                else:
                    outputs = module._map_external(backend, inputs, n_rows)
                for n, o in zip(module.output_vars, outputs):
                    d[n] = o
                for n in module._delete_vars:
                    del d[n]
            out = d
        else:
            out = jax.vmap(single)(flat)
        return out, x.shape[:-1]

    def fun(self, x, original_space=None, use_surrogate=None):
        """Evaluate the pipeline; returns VariableDict(s)
        (``density.py:407-478``)."""
        original_space, use_surrogate = self._check_os_us(original_space,
                                                          use_surrogate)
        out, batch = self._vmapped_eval(x, original_space, use_surrogate)
        if batch is False:
            vd = VariableDict()
            for k, v in out.items():
                vd._fun[k] = np.asarray(v)
            return vd
        n = int(np.prod(batch))
        vds = np.empty(n, dtype=object)
        host = {k: np.asarray(v) for k, v in out.items()}
        for i in range(n):
            vd = VariableDict()
            for k in host:
                vd._fun[k] = host[k][i]
            vds[i] = vd
        return vds.reshape(batch)

    __call__ = fun

    def fun_and_jac(self, x, original_space=None, use_surrogate=None):
        """Evaluate values and full input-Jacobians (``density.py:487-566``)."""
        original_space, use_surrogate = self._check_os_us(original_space,
                                                          use_surrogate)
        params = self.current_params()

        def single(xi):
            return self._eval_vars(xi, params, original_space, use_surrogate)

        x = jnp.asarray(x, get_dtype())

        def one(xi):
            vals = single(xi)
            jacs = jax.jacrev(single)(xi)
            return vals, jacs

        if x.ndim == 1:
            vals, jacs = one(x)
            vd = VariableDict()
            for k in vals:
                vd._fun[k] = np.asarray(vals[k])
                vd._jac[k] = np.asarray(jacs[k])
            return vd
        flat = x.reshape((-1, x.shape[-1]))
        vals, jacs = jax.vmap(one)(flat)
        n = flat.shape[0]
        vds = np.empty(n, dtype=object)
        hv = {k: np.asarray(v) for k, v in vals.items()}
        hj = {k: np.asarray(v) for k, v in jacs.items()}
        for i in range(n):
            vd = VariableDict()
            for k in hv:
                vd._fun[k] = hv[k][i]
                vd._jac[k] = hj[k][i]
            vds[i] = vd
        return vds.reshape(x.shape[:-1])

    jac = fun_and_jac


class Density(Pipeline, _DensityBase):
    """Pipeline specialized for log-densities (``density.py:617-838``)."""

    def __init__(self, density_name='__var__', decay_options=None,
                 return_dict=False, **kwargs):
        self.density_name = density_name
        self.return_dict = return_dict
        super().__init__(**kwargs)
        if decay_options is None:
            decay_options = {}
        self.set_decay_options(**decay_options)
        self._mu = None
        self._hess = None
        self._alpha_2_val = np.inf

    @property
    def density_name(self):
        return self._density_name

    @density_name.setter
    def density_name(self, name):
        self._density_name = str(name)

    @property
    def return_dict(self):
        return self._return_dict

    @return_dict.setter
    def return_dict(self, rd):
        self._return_dict = bool(rd)

    # ------------- decay penalty (``density.py:756-811``) -------------

    def set_decay_options(self, use_decay=False, alpha=None, alpha_p=150.,
                          gamma=0.1):
        self._use_decay = bool(use_decay)
        if alpha is None:
            self._alpha = None
        else:
            alpha = float(alpha)
            if alpha <= 0:
                raise ValueError('invalid value for alpha.')
            self._alpha = alpha
            self._alpha_2_val = alpha ** 2
        if alpha_p is None:
            if alpha is None:
                raise ValueError('alpha and alpha_p cannot both be None.')
            self._alpha_p = None
        else:
            alpha_p = float(alpha_p)
            if alpha_p <= 0:
                raise ValueError('invalid value for alpha_p.')
            self._alpha_p = alpha_p
        gamma = float(gamma)
        if gamma <= 0:
            raise ValueError('invalid value for gamma.')
        self._gamma = gamma

    def _set_decay(self, x):
        x = np.ascontiguousarray(x)
        if x.ndim != 2:
            raise ValueError('invalid value for x.')
        self._mu = np.mean(x, axis=0)
        self._hess = np.linalg.inv(np.cov(x, rowvar=False))
        if self._alpha_p is not None:
            beta = np.einsum('ij,jk,ik->i', x - self._mu, self._hess,
                             x - self._mu) ** 0.5
            if self._alpha_p < 100:
                self._alpha = np.percentile(beta, self._alpha_p)
            else:
                self._alpha = np.max(beta) * self._alpha_p / 100
            self._alpha_2_val = self._alpha ** 2

    def current_params(self):
        params = super().current_params()
        if self._mu is not None:
            dim = self._mu.shape[0]
        else:
            dim = self.input_size if self.input_size is not None else 1
        dtype = get_dtype()
        params['decay'] = (
            jnp.zeros(dim, dtype) if self._mu is None
            else jnp.asarray(self._mu, dtype),
            jnp.eye(dim, dtype=dtype) if self._hess is None
            else jnp.asarray(self._hess, dtype),
            jnp.asarray(self._alpha_2_val, dtype),
        )
        return params

    # ------------- traced logp -------------

    def _logp_traced(self, x, params, original_space, use_surrogate):
        x = jnp.asarray(x, get_dtype())
        if original_space:
            x_o, logdet = x, None
        else:
            # fused transform + log-Jacobian (one exp + one log, rational
            # custom JVP) — the sampler hot path; see ops.constraint
            x_o, logdet = _con.to_original_with_logdet(
                x, self._input_scales, self._hard_bounds)
        d = self._eval_vars(x_o, params, True, use_surrogate)
        lp = jnp.reshape(d[self._density_name], (-1,))[0]
        if self._use_decay and use_surrogate:
            mu, hess, alpha_2 = params['decay']
            delta = x_o - mu
            beta2 = delta @ hess @ delta
            lp = lp - self._gamma * jnp.clip(beta2 - alpha_2, 0.0, jnp.inf)
        if logdet is not None:
            lp = lp + logdet
        return lp

    def device_logp_and_grad(self, original_space=False, use_surrogate=None):
        """``fn(params, x) -> (logp, grad)`` for the sampler hot loop."""
        _, us = self._check_os_us(None, use_surrogate)

        def fn(params, x):
            f = lambda xi: self._logp_traced(xi, params, original_space, us)
            return jax.value_and_grad(f)(x)

        return fn

    def device_logp(self, original_space=False, use_surrogate=None):
        """Traceable scalar ``fn(x)`` with current params bound (for
        optimizers / Laplace autodiff)."""
        _, us = self._check_os_us(None, use_surrogate)
        params = self.current_params()
        return lambda x: self._logp_traced(jnp.asarray(x, get_dtype()),
                                           params, original_space, us)

    # ------------- host API -------------

    def logp(self, x, original_space=None, use_surrogate=None,
             return_dict=None):
        original_space, us = self._check_os_us(original_space, use_surrogate)
        return_dict = self.return_dict if return_dict is None else return_dict
        params = self.current_params()
        x = jnp.asarray(x, get_dtype())
        f = lambda xi: self._logp_traced(xi, params, original_space, us)
        if x.ndim == 1:
            lp = np.asarray(f(x))
        elif self._has_external(us):
            flat = x.reshape((-1, x.shape[-1]))
            lp = np.asarray([np.asarray(f(flat[i]))
                             for i in range(flat.shape[0])]).reshape(
                x.shape[:-1])
        else:
            flat = x.reshape((-1, x.shape[-1]))
            lp = np.asarray(jax.vmap(f)(flat)).reshape(x.shape[:-1])
        if return_dict:
            return lp, self.fun(np.asarray(x), original_space, us)
        return lp

    __call__ = logp

    def grad(self, x, original_space=None, use_surrogate=None,
             return_dict=None):
        return self.logp_and_grad(x, original_space, use_surrogate,
                                  return_dict)[1]

    def logp_and_grad(self, x, original_space=None, use_surrogate=None,
                      return_dict=None):
        original_space, us = self._check_os_us(original_space, use_surrogate)
        return_dict = self.return_dict if return_dict is None else return_dict
        params = self.current_params()
        fn = self.device_logp_and_grad(original_space, us)
        x = jnp.asarray(x, get_dtype())
        if x.ndim == 1:
            lp, g = fn(params, x)
        else:
            flat = x.reshape((-1, x.shape[-1]))
            lp, g = jax.vmap(lambda xi: fn(params, xi))(flat)
            lp = jnp.reshape(lp, x.shape[:-1])
            g = jnp.reshape(g, x.shape)
        if return_dict:
            return (np.asarray(lp), np.asarray(g),
                    self.fun_and_jac(np.asarray(x), original_space, us))
        return np.asarray(lp), np.asarray(g)

    # ------------- fitting (``density.py:813-838``) -------------

    def fit(self, var_dicts):
        """Fit every surrogate module from collected training VariableDicts."""
        var_dicts = np.asarray(var_dicts).reshape(-1)
        if not all_isinstance(var_dicts, VariableDict):
            raise ValueError('var_dicts should consist of VariableDict(s).')
        x = self._get_var(var_dicts, self.input_vars)
        if self._use_decay:
            self._set_decay(x)
        logp = self._get_logp(var_dicts)
        for su in self._surrogate_list:
            x_s = self._get_var(var_dicts, su.input_vars)
            if su._input_scales is not None:
                x_s = (x_s - su._input_scales[:, 0]) / su._input_scales_diff
            y_s = self._get_var(var_dicts, su.output_vars)
            su.fit(x_s, y_s, logp, **su.fit_options)

    @classmethod
    def _get_var(cls, var_dicts, var_names):
        return np.array([np.concatenate([np.atleast_1d(vd._fun[vn])
                                         for vn in var_names])
                         for vd in var_dicts])

    def _get_logp(self, var_dicts):
        return self._get_var(var_dicts, [self.density_name])[..., 0]
