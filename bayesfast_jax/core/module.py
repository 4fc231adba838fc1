"""Module graph nodes (``bayesfast/core/module.py``).

A ``Module`` wraps a JAX-traceable callable as a named-variable graph node
with input/output variable names, optional concat/split reshaping
(``input_shapes``/``output_shapes``), and affine input rescaling
(``input_scales``). Differences from the reference, which come from
composing modules into one jitted device program:

* Module callables operate on jnp arrays and must be traceable; the pipeline
  composes them into one jitted program, so Jacobians come from autodiff by
  default (an explicit ``jac`` is honored when supplied, and must itself be
  traceable).
* Dynamic (fit-time-mutable) arrays — surrogate coefficients, bound centers —
  are exposed through ``dynamic_params()``/``_with_params`` so the sampler
  threads them as runtime arguments and surrogate refits never trigger a
  recompile (the reference mutates module attributes in place,
  ``poly.py:574-587``).
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp

from ..utils import all_isinstance
from ..utils.collections import PropertyList
from ..config import get_dtype

__all__ = ['ModuleBase', 'Module', 'Surrogate', 'SurrogateScope']

from collections import namedtuple

SurrogateScope = namedtuple('SurrogateScope', ['i_step', 'n_step'])


def _external_row_job(fun, fun_args, fun_kwargs, np_args):
    """One external evaluation for the host pool — top-level so process
    pools can pickle it, numpy-only so workers never touch JAX."""
    out = fun(*np_args, *fun_args, **fun_kwargs)
    if not isinstance(out, (list, tuple)):
        out = [out]
    return np.concatenate([np.atleast_1d(np.asarray(o, np.float64))
                           for o in out])


class ModuleBase:
    """Base class: subclasses define ``_fun`` (and optionally ``_jac``,
    ``_fun_and_jac``); see ``Module`` for the wrapper that takes callables."""

    def __init__(self, input_vars='__var__', output_vars='__var__',
                 delete_vars=(), input_shapes=None, output_shapes=None,
                 input_scales=None, label=None, fun_args=(), fun_kwargs=None,
                 jac_args=(), jac_kwargs=None, fun_and_jac_args=(),
                 fun_and_jac_kwargs=None, concat_input=None, traceable=True):
        self._traceable = bool(traceable)
        self.input_vars = input_vars
        self.output_vars = output_vars
        self.delete_vars = delete_vars
        self.input_shapes = input_shapes
        self.output_shapes = output_shapes
        self.input_scales = input_scales
        self.label = label
        self.fun_args = fun_args
        self.fun_kwargs = fun_kwargs
        self.jac_args = jac_args
        self.jac_kwargs = jac_kwargs
        self.fun_and_jac_args = fun_and_jac_args
        self.fun_and_jac_kwargs = fun_and_jac_kwargs
        self.reset_counter()

    # ------------- dynamic parameter threading -------------

    def dynamic_params(self):
        """Pytree of runtime-mutable arrays (empty for plain modules)."""
        return ()

    def _with_params(self, params):
        """Context value passed back into traced evaluation; default unused."""
        return params

    # ------------- traced evaluation -------------

    def _prepare_inputs(self, args):
        """Concat/rescale/split input variables (``module.py:47-96``)."""
        args = [jnp.atleast_1d(jnp.asarray(a, get_dtype())) for a in args]
        shapes = self._input_shapes
        cum = self._input_cum
        if shapes is None:
            if self._input_scales is None:
                return args
            sizes = [int(a.shape[0]) for a in args]
            cum = np.cumsum([0] + sizes)
            shapes = np.asarray(sizes)
        cargs = jnp.concatenate(args, axis=0)
        if self._input_scales is not None:
            lo = jnp.asarray(self._input_scales[:, 0], cargs.dtype)
            diff = jnp.asarray(self._input_scales_diff, cargs.dtype)
            cargs = (cargs - lo) / diff
        if shapes.size > 1:
            return [cargs[cum[i]:cum[i + 1]] for i in range(shapes.size)]
        return [cargs]

    def _prepare_outputs(self, out):
        """Normalize fun output to a list with one entry per output var."""
        if isinstance(out, (list, tuple)):
            out = [jnp.atleast_1d(jnp.asarray(o)) for o in out]
        else:
            out = [jnp.atleast_1d(jnp.asarray(out))]
        shapes = self._output_shapes
        cum = self._output_cum
        if shapes is None:
            return out
        cargs = jnp.concatenate(out, axis=0)
        if shapes.size > 1:
            return [cargs[cum[i]:cum[i + 1]] for i in range(shapes.size)]
        return [cargs]

    @property
    def traceable(self):
        return getattr(self, '_traceable', True)

    def _call_traced(self, args, params=None):
        """Traced single-point evaluation: list-of-inputs -> list-of-outputs."""
        args = self._prepare_inputs(args)
        ctx = self._with_params(params)
        if not self.traceable:
            out = self._call_external(args)
        else:
            out = self._fun_traced(ctx, *args)
        return self._prepare_outputs(out)

    def _call_external(self, args):
        """Host callback for non-traceable (external) callables.

        The cosmosis-style escape hatch (SURVEY §7 'hard parts'): the true
        model runs on host via ``jax.pure_callback`` while surrogate sampling
        stays on device. Requires ``output_shapes``; the result is not
        differentiable — which the surrogate workflow never needs (fits use
        values only, sampling differentiates the surrogate).
        """
        if self._output_shapes is None:
            raise ValueError('non-traceable modules need output_shapes to '
                             'declare their output size.')
        total = int(np.sum(self._output_shapes))
        dtype = get_dtype()

        def host_fn(*np_args):
            out = self._fun(*[np.asarray(a) for a in np_args],
                            *self._fun_args, **self._fun_kwargs)
            if not isinstance(out, (list, tuple)):
                out = [out]
            return np.concatenate(
                [np.atleast_1d(np.asarray(o)) for o in out]).astype(dtype)

        if not any(isinstance(a, jax.core.Tracer)
                   for a in jax.tree.leaves(args)):
            # eager: call the external model directly, without a callback
            return jnp.asarray(host_fn(*args))

        return jax.pure_callback(
            host_fn, jax.ShapeDtypeStruct((total,), dtype), *args,
            vmap_method='sequential')

    def _fun_traced(self, ctx, *args):
        """Default: delegate to ``self._fun`` ignoring the params context."""
        return self._fun(*args, *self._fun_args, **self._fun_kwargs)

    def _map_external(self, backend, batched_inputs, n_rows):
        """Batched external dispatch over a host pool.

        Prepares every row's inputs in-process (rescale/reshape touch JAX),
        ships ONLY the raw user callable plus numpy args to the backend's
        workers, and splits the outputs in-process — so a process pool
        (``ParallelBackend(kind='processes')``, the GIL-proof analog of the
        reference's 64-process DES map, ``recipe.py:1085-1087``) never
        imports or touches JAX in its workers.
        """
        if self._output_shapes is None:
            raise ValueError('non-traceable modules need output_shapes to '
                             'declare their output size.')
        dtype = get_dtype()
        rows = []
        for i in range(n_rows):
            prepped = self._prepare_inputs(
                [np.asarray(a[i]) for a in batched_inputs])
            rows.append(tuple(np.asarray(p) for p in prepped))
        outs = backend.map(_external_row_job,
                           [self._fun] * n_rows, [self._fun_args] * n_rows,
                           [self._fun_kwargs] * n_rows, rows)
        cat = np.stack([np.asarray(o) for o in outs]).astype(dtype)
        shapes = self._output_shapes
        cum = self._output_cum
        if shapes.size > 1:
            return [jnp.asarray(cat[:, cum[i]:cum[i + 1]])
                    for i in range(shapes.size)]
        return [jnp.asarray(cat)]

    # ------------- host-facing wrappers -------------

    @property
    def fun(self):
        if self.has_fun or hasattr(self, '_fun_traced'):
            self._ncall_fun += 1
            return self._fun_wrapped
        raise RuntimeError('No valid definition of fun is found.')

    @fun.setter
    def fun(self, function):
        if callable(function) or function is None:
            self._fun = function
        else:
            raise ValueError('fun should be callable, or None if you want to '
                             'reset it.')

    def _fun_wrapped(self, *args):
        out = self._call_traced(list(args), self.dynamic_params())
        return [np.asarray(o) for o in out]

    __call__ = _fun_wrapped

    @property
    def has_fun(self):
        return getattr(self, '_fun', None) is not None

    @property
    def jac(self):
        self._ncall_jac += 1
        return self._jac_wrapped

    @jac.setter
    def jac(self, jacobian):
        if callable(jacobian) or jacobian is None:
            self._jac = jacobian
        else:
            raise ValueError('jac should be callable, or None if you want to '
                             'reset it.')

    def _jac_wrapped(self, *args):
        """Jacobians of each output var w.r.t. the concatenated raw inputs.

        Computed with ``jax.jacfwd``/``jacrev`` through the full traced
        evaluation (rescaling included), replacing the reference's manual
        ``j / input_scales_diff`` bookkeeping (``module.py:182-186``).
        """
        params = self.dynamic_params()
        sizes = [int(np.atleast_1d(np.asarray(a)).shape[0]) for a in args]
        cum = np.cumsum([0] + sizes)
        flat = jnp.concatenate(
            [jnp.atleast_1d(jnp.asarray(a, get_dtype())) for a in args])

        def f(x):
            parts = [x[cum[i]:cum[i + 1]] for i in range(len(sizes))]
            return self._call_traced(parts, params)

        n_in = int(flat.shape[0])
        jac_fn = jax.jacfwd(f) if n_in <= 8 else jax.jacrev(f)
        out = jac_fn(flat)
        return [np.asarray(j) for j in out]

    @property
    def has_jac(self):
        return getattr(self, '_jac', None) is not None

    @property
    def fun_and_jac(self):
        self._ncall_fun_and_jac += 1
        return lambda *args: (self._fun_wrapped(*args),
                              self._jac_wrapped(*args))

    @fun_and_jac.setter
    def fun_and_jac(self, fun_jac):
        if callable(fun_jac) or fun_jac is None:
            self._fun_and_jac = fun_jac
        else:
            raise ValueError('fun_and_jac should be callable, or None if you '
                             'want to reset it.')

    @property
    def has_fun_and_jac(self):
        return getattr(self, '_fun_and_jac', None) is not None

    # ------------- call counters (``module.py:236-246,493-496``) -------------

    @property
    def ncall_fun(self):
        return self._ncall_fun

    @property
    def ncall_jac(self):
        return self._ncall_jac

    @property
    def ncall_fun_and_jac(self):
        return self._ncall_fun_and_jac

    def reset_counter(self):
        self._ncall_fun = 0
        self._ncall_jac = 0
        self._ncall_fun_and_jac = 0

    # ------------- var-name plumbing (``module.py:248-335``) -------------

    @staticmethod
    def _var_check(names, tag, handle_repeat='remove', min_length=1,
                   max_length=np.inf):
        if isinstance(names, str):
            names = [names]
        else:
            names = list(names)
            if not all_isinstance(names, str):
                raise ValueError(f'{tag}_vars should be a str or an '
                                 'array_like of str.')
            if len(names) != len(set(names)):
                if handle_repeat == 'remove':
                    names = list(dict.fromkeys(names))
                    warnings.warn('removing repeated elements found in '
                                  f'{tag}_vars', RuntimeWarning)
                elif handle_repeat == 'ignore':
                    pass
                elif handle_repeat == 'warn':
                    warnings.warn(f'repeated elements found in {tag}_vars',
                                  RuntimeWarning)
                elif handle_repeat == 'raise':
                    raise ValueError(f'some elements in {tag}_vars are not '
                                     'unique.')
        if len(names) < min_length:
            raise ValueError('the length of this var list is smaller than '
                             f'min_length={min_length}.')
        if len(names) > max_length:
            raise ValueError('the length of this var list is larger than '
                             f'max_length={max_length}.')
        return names

    _input_min_length = 1
    _input_max_length = np.inf
    _output_min_length = 1
    _output_max_length = np.inf
    _delete_min_length = 0
    _delete_max_length = np.inf

    @property
    def input_vars(self):
        return self._input_vars

    @input_vars.setter
    def input_vars(self, names):
        self._input_vars = PropertyList(
            names, lambda x: self._var_check(
                x, 'input', 'ignore', self._input_min_length,
                self._input_max_length))

    @property
    def output_vars(self):
        return self._output_vars

    @output_vars.setter
    def output_vars(self, names):
        self._output_vars = PropertyList(
            names, lambda x: self._var_check(
                x, 'output', 'raise', self._output_min_length,
                self._output_max_length))

    @property
    def delete_vars(self):
        return self._delete_vars

    @delete_vars.setter
    def delete_vars(self, names):
        self._delete_vars = PropertyList(
            names, lambda x: self._var_check(
                x, 'delete', 'remove', self._delete_min_length,
                self._delete_max_length))

    def _shape_check(self, shapes, tag):
        shapes = np.atleast_1d(shapes).astype(int)
        if not (shapes.ndim == 1 and shapes.size > 0):
            raise ValueError(f'invalid value for {tag}_shapes.')
        if shapes.size > 1 and not np.all(shapes > 0):
            raise ValueError(f'invalid value for {tag}_shapes.')
        cum = np.cumsum(np.insert(shapes, 0, 0))
        if tag == 'input':
            self._input_cum = cum
        else:
            self._output_cum = cum
        return shapes

    @property
    def input_shapes(self):
        return self._input_shapes

    @input_shapes.setter
    def input_shapes(self, shapes):
        if shapes is None:
            self._input_shapes = None
            self._input_cum = None
        else:
            self._input_shapes = self._shape_check(shapes, 'input')

    @property
    def output_shapes(self):
        return self._output_shapes

    @output_shapes.setter
    def output_shapes(self, shapes):
        if shapes is None:
            self._output_shapes = None
            self._output_cum = None
        else:
            self._output_shapes = self._shape_check(shapes, 'output')

    @property
    def input_scales(self):
        return self._input_scales

    @input_scales.setter
    def input_scales(self, scales):
        if scales is None:
            self._input_scales = None
            self._input_scales_diff = 1.
        else:
            scales = np.ascontiguousarray(scales, dtype=np.float64)
            if scales.ndim == 1:
                scales = np.stack([np.zeros_like(scales), scales], axis=-1)
            if not (scales.ndim == 2 and scales.shape[-1] == 2):
                raise ValueError('invalid value for input_scales.')
            self._input_scales = scales
            self._input_scales_diff = scales[:, 1] - scales[:, 0]

    @property
    def label(self):
        return self._label

    @label.setter
    def label(self, tag):
        if isinstance(tag, str) or tag is None:
            self._label = tag
        else:
            raise ValueError('label should be a str or None.')

    @staticmethod
    def _args_setter(args, tag):
        if args is None:
            return ()
        return tuple(args)

    @staticmethod
    def _kwargs_setter(kwargs, tag):
        if kwargs is None:
            return {}
        return dict(kwargs)

    @property
    def fun_args(self):
        return self._fun_args

    @fun_args.setter
    def fun_args(self, args):
        self._fun_args = self._args_setter(args, 'fun')

    @property
    def fun_kwargs(self):
        return self._fun_kwargs

    @fun_kwargs.setter
    def fun_kwargs(self, kwargs):
        self._fun_kwargs = self._kwargs_setter(kwargs, 'fun')

    @property
    def jac_args(self):
        return self._jac_args

    @jac_args.setter
    def jac_args(self, args):
        self._jac_args = self._args_setter(args, 'jac')

    @property
    def jac_kwargs(self):
        return self._jac_kwargs

    @jac_kwargs.setter
    def jac_kwargs(self, kwargs):
        self._jac_kwargs = self._kwargs_setter(kwargs, 'jac')

    @property
    def fun_and_jac_args(self):
        return self._fun_and_jac_args

    @fun_and_jac_args.setter
    def fun_and_jac_args(self, args):
        self._fun_and_jac_args = self._args_setter(args, 'fun_and_jac')

    @property
    def fun_and_jac_kwargs(self):
        return self._fun_and_jac_kwargs

    @fun_and_jac_kwargs.setter
    def fun_and_jac_kwargs(self, kwargs):
        self._fun_and_jac_kwargs = self._kwargs_setter(kwargs, 'fun_and_jac')

    def print_summary(self):
        raise NotImplementedError


class Module(ModuleBase):
    """Basic wrapper for user-defined JAX-traceable callables
    (``module.py:502-552``)."""

    def __init__(self, fun=None, jac=None, fun_and_jac=None, **kwargs):
        self.fun = fun
        self.jac = jac
        self.fun_and_jac = fun_and_jac
        super().__init__(**kwargs)

    def _fun_traced(self, ctx, *args):
        if getattr(self, '_fun', None) is not None:
            return self._fun(*args, *self._fun_args, **self._fun_kwargs)
        if getattr(self, '_fun_and_jac', None) is not None:
            return self._fun_and_jac(*args, *self._fun_and_jac_args,
                                     **self._fun_and_jac_kwargs)[0]
        raise RuntimeError('No valid definition of fun is found.')

    def _jac_wrapped(self, *args):
        if getattr(self, '_jac', None) is not None:
            args_p = self._prepare_inputs(list(args))
            jac_out = self._jac(*args_p, *self._jac_args, **self._jac_kwargs)
            if not isinstance(jac_out, (list, tuple)):
                jac_out = [jac_out]
            jac_out = [np.atleast_2d(np.asarray(j)) for j in jac_out]
            return [j / self._input_scales_diff for j in jac_out]
        return super()._jac_wrapped(*args)


class Surrogate(ModuleBase):
    """Base class for surrogate modules (``module.py:558-687``)."""

    def __init__(self, input_size=None, output_size=None, scope=(0, 1),
                 fit_options=None, **kwargs):
        self._initialized = False
        if 'input_shapes' not in kwargs:
            kwargs['input_shapes'] = -1
        super().__init__(**kwargs)
        if input_size is None:
            if self.input_shapes is None or self.input_shapes.size <= 1:
                raise ValueError('failed to infer input_size from '
                                 'input_shapes.')
            input_size = int(np.sum(self.input_shapes))
        if output_size is None:
            if self.output_shapes is None or self.output_shapes.size <= 1:
                raise ValueError('failed to infer output_size from '
                                 'output_shapes.')
            output_size = int(np.sum(self.output_shapes))
        self.input_size = input_size
        self.output_size = output_size
        self.scope = scope
        self.fit_options = fit_options
        self._initialized = True

    @property
    def scope(self):
        return self._scope

    @scope.setter
    def scope(self, s):
        i_step, n_step = s
        if n_step <= 0:
            raise ValueError('invalid value for scope.')
        self._scope = SurrogateScope(int(i_step), int(n_step))

    @property
    def fit_options(self):
        return self._fit_options

    @fit_options.setter
    def fit_options(self, options):
        self._fit_options = {} if options is None else dict(options)

    @property
    def input_size(self):
        return self._input_size

    @input_size.setter
    def input_size(self, size):
        if self._initialized:
            raise RuntimeError('input_size cannot be modified after '
                               'initialization.')
        size = int(size)
        if size <= 0:
            raise ValueError('input_size should be a positive int.')
        self._input_size = size

    @property
    def output_size(self):
        return self._output_size

    @output_size.setter
    def output_size(self, size):
        if self._initialized:
            raise RuntimeError('output_size cannot be modified after '
                               'initialization.')
        size = int(size)
        if size <= 0:
            raise ValueError('output_size should be a positive int.')
        self._output_size = size

    def fit(self, *args, **kwargs):
        raise NotImplementedError('Abstract Method.')

    @property
    def n_param(self):
        raise NotImplementedError('Abstract Property.')
