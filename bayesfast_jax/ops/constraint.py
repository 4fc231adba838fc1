"""Bounded <-> unbounded constraint transforms, vectorized for XLA.

Device equivalent of the reference's 12 Cython kernels
(``bayesfast/transforms/_constraint.pyx:19-226``). The per-dimension scalar
loops with data-dependent branches become branch-free masked elementwise
ops over the last axis, batched over arbitrary leading axes; the three derivative orders
(f, j = d/dx, jj = d2/dx2) keep the reference's exact formulas:

With ``t = (x - lo) / (hi - lo)`` and bound flags (lower, upper):
  * both bounds:  y = logit(t)
  * lower only:   y = log(t)
  * upper only:   y = log(1 - t)
  * no bounds:    y = t   (pure affine rescale)
and ``to_original`` is the inverse (sigmoid / exp / 1-exp) mapped back through
the affine rescale.

Out-of-bound inputs produce nan/inf instead of raising (the reference raises
``ValueError``; raising is impossible under jit — samplers treat non-finite
logp as divergence/rejection, which is the behaviorally equivalent outcome).

``scales`` is ``None`` (identity) or an ``(n, 2)`` array of [lo, hi];
``hard_bounds`` is a bool, or an ``(n,)``/``(n, 2)`` bool array.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ..config import get_dtype

__all__ = [
    'normalize_scales', 'normalize_bounds',
    'from_original', 'from_original_grad', 'from_original_grad2',
    'to_original', 'to_original_grad', 'to_original_grad2',
    'to_original_with_logdet',
]


def normalize_scales(scales):
    """Return scales as an (n, 2) float array, or None."""
    if scales is None:
        return None
    scales = np.asarray(scales, dtype=np.float64)
    if scales.ndim == 1:
        scales = np.stack([np.zeros_like(scales), scales], axis=-1)
    if not (scales.ndim == 2 and scales.shape[-1] == 2):
        raise ValueError('I do not know how to interpret the shape of '
                         'input_scales.')
    return scales


def normalize_bounds(bounds, n):
    """Return hard_bounds as an (n, 2) bool array."""
    if isinstance(bounds, bool):
        return np.full((n, 2), bounds)
    bounds = np.atleast_1d(bounds).astype(bool)
    if bounds.ndim == 1:
        bounds = np.stack([bounds, bounds], axis=-1)
    if not (bounds.ndim == 2 and bounds.shape[-1] == 2):
        raise ValueError('I do not know how to interpret the shape of '
                         'hard_bounds.')
    return bounds


def _prep(x, scales, bounds):
    dtype = get_dtype()
    x = jnp.asarray(x, dtype)
    lo = jnp.asarray(scales[:, 0], dtype)
    hi = jnp.asarray(scales[:, 1], dtype)
    width = hi - lo
    b = normalize_bounds(bounds, scales.shape[0])
    has_lo = jnp.asarray(b[:, 0])
    has_hi = jnp.asarray(b[:, 1])
    return x, lo, width, has_lo, has_hi


def from_original(x, scales, bounds):
    """Map original (bounded) coordinates to unbounded sampling coordinates."""
    if scales is None:
        return jnp.asarray(x, get_dtype())
    x, lo, width, has_lo, has_hi = _prep(x, scales, bounds)
    t = (x - lo) / width
    both = has_lo & has_hi
    y = jnp.where(both, jnp.log(t) - jnp.log1p(-t), t)
    y = jnp.where(has_lo & ~has_hi, jnp.log(t), y)
    y = jnp.where(~has_lo & has_hi, jnp.log1p(-t), y)
    return y


def from_original_grad(x, scales, bounds):
    """d(from_original)/dx, elementwise (the Jacobian is diagonal)."""
    if scales is None:
        return jnp.ones_like(jnp.asarray(x, get_dtype()))
    x, lo, width, has_lo, has_hi = _prep(x, scales, bounds)
    t = (x - lo) / width
    g = jnp.where(has_lo & has_hi, 1.0 / (t * (1.0 - t)),
                  jnp.ones_like(t))
    g = jnp.where(has_lo & ~has_hi, 1.0 / t, g)
    g = jnp.where(~has_lo & has_hi, 1.0 / (t - 1.0), g)
    return g / width


def from_original_grad2(x, scales, bounds):
    """d2(from_original)/dx2, elementwise."""
    if scales is None:
        return jnp.zeros_like(jnp.asarray(x, get_dtype()))
    x, lo, width, has_lo, has_hi = _prep(x, scales, bounds)
    t = (x - lo) / width
    omt = 1.0 - t
    g = jnp.where(has_lo & has_hi, (2.0 * t - 1.0) / (t * t * omt * omt),
                  jnp.zeros_like(t))
    g = jnp.where(has_lo & ~has_hi, -1.0 / (t * t), g)
    g = jnp.where(~has_lo & has_hi, 1.0 / ((t - 1.0) * omt), g)
    return g / (width * width)


def to_original(x, scales, bounds):
    """Map unbounded sampling coordinates back to original coordinates."""
    if scales is None:
        return jnp.asarray(x, get_dtype())
    x, lo, width, has_lo, has_hi = _prep(x, scales, bounds)
    t = jnp.where(has_lo & has_hi, 1.0 / (1.0 + jnp.exp(-x)), x)
    t = jnp.where(has_lo & ~has_hi, jnp.exp(x), t)
    t = jnp.where(~has_lo & has_hi, 1.0 - jnp.exp(x), t)
    return lo + t * width


def to_original_grad(x, scales, bounds):
    """d(to_original)/dx, elementwise."""
    if scales is None:
        return jnp.ones_like(jnp.asarray(x, get_dtype()))
    x, lo, width, has_lo, has_hi = _prep(x, scales, bounds)
    sig = 1.0 / (1.0 + jnp.exp(-x))
    g = jnp.where(has_lo & has_hi, sig * (1.0 - sig), jnp.ones_like(x))
    g = jnp.where(has_lo & ~has_hi, jnp.exp(x), g)
    g = jnp.where(~has_lo & has_hi, -jnp.exp(x), g)
    return g * width


def to_original_grad2(x, scales, bounds):
    """d2(to_original)/dx2, elementwise."""
    if scales is None:
        return jnp.zeros_like(jnp.asarray(x, get_dtype()))
    x, lo, width, has_lo, has_hi = _prep(x, scales, bounds)
    ex = jnp.exp(x)
    g = jnp.where(has_lo & has_hi,
                  -ex * (ex - 1.0) / ((ex + 1.0) ** 3),
                  jnp.zeros_like(x))
    g = jnp.where(has_lo & ~has_hi, ex, g)
    g = jnp.where(~has_lo & has_hi, -ex, g)
    return g * width


# exp-argument clamp for the fused transform: e^85 = 8.2e36 stays below
# float32 max (no inf -> no 0*inf NaN under arithmetic masking) and
# 1/(1+e^85) = 1.17e-37 stays above the float32 denormal range (kernels
# may flush denormals to zero). Beyond the clamp the two-sided branch
# saturates (the float32 unfused path saturated there too); the one-sided
# logdet stays EXACT at any x because log|exp(x)| == x analytically.
_FUSED_CLAMP = 85.0


def _fused_core(x, lo, width, m_lohi, m_lo, m_hi):
    """Shared primal math for the fused transform and its JVP.

    Branch combination is ARITHMETIC masking (mul-add over the 0/1 mask
    operands), not ``jnp.where``; which form is faster on the GPU is not
    measured. NaN-safety without selects comes from clamping the exp argument
    (see ``_FUSED_CLAMP``): ``exp`` then never overflows, so masked-out
    branches multiply finite garbage by 0.0 instead of ``0 * inf``
    (the round-4 advisor finding).
    """
    m_none = 1.0 - m_lohi - m_lo - m_hi
    xc = jnp.clip(x, -_FUSED_CLAMP, _FUSED_CLAMP)
    em = jnp.exp(-xc)            # in [e^-85, e^85]: never inf or 0
    ep = 1.0 / em
    s = 1.0 / (1.0 + em)         # sigmoid(xc), >= 1.17e-37
    t = m_lohi * s + m_lo * ep + m_hi * (1.0 - ep) + m_none * x
    x_o = lo + t * width
    s1s = s * (1.0 - s)
    return em, ep, s, s1s, x_o, m_none


@jax.custom_jvp
def _fused_to_original(x, lo, width, m_lohi, m_lo, m_hi, logw):
    """(to_original(x), sum log|d to_original/dx|) with ONE exp + ONE log.

    The straightforward composition ``logp(to_original(x)) +
    sum(log|to_original_grad(x)|)`` costs ~6 exp under value_and_grad
    (forward sigmoid, the grad's sigmoid, and their autodiff replays).
    Here the exponential is evaluated once on a clamped argument,
    the only per-element log sees the two-sided branch's s(1-s) (masked
    to 1 elsewhere), the one-sided branches contribute their logdet
    EXACTLY as ``x`` (log(exp(x)) == x analytically — no transcendental,
    no overflow at any x), ``logw`` carries the constant
    sum-of-log|width| over bounded dims folded at trace time, and the
    custom JVP below keeps the tangent map purely rational.
    """
    em, ep, s, s1s, x_o, m_none = _fused_core(x, lo, width,
                                              m_lohi, m_lo, m_hi)
    arg = m_lohi * s1s + (1.0 - m_lohi)
    logdet = jnp.sum(jnp.log(arg) + (m_lo + m_hi) * x, axis=-1) + logw
    return x_o, logdet


@_fused_to_original.defjvp
def _fused_to_original_jvp(primals, tangents):
    x, lo, width, m_lohi, m_lo, m_hi, logw = primals
    dx = tangents[0]
    em, ep, s, s1s, x_o, m_none = _fused_core(x, lo, width,
                                              m_lohi, m_lo, m_hi)
    arg = m_lohi * s1s + (1.0 - m_lohi)
    logdet = jnp.sum(jnp.log(arg) + (m_lo + m_hi) * x, axis=-1) + logw
    # dt/dx per branch: lohi s(1-s); lo exp(x); hi -exp(x); none 1
    g = (m_lohi * s1s + (m_lo - m_hi) * ep + m_none) * width
    # dlog|g|/dx per branch: lohi (1-2s); lo 1; hi 1; none 0
    h = m_lohi * (1.0 - 2.0 * s) + m_lo + m_hi
    dx_o = g * dx
    dlogdet = jnp.sum(h * dx, axis=-1)
    return (x_o, logdet), (dx_o, dlogdet)


# ---------------------------------------------------------------------------
# Host (NumPy) twins of the six transforms. The device (jnp) versions above
# execute op-by-op when handed host arrays outside jit, which round-trips
# the whole batch between host and device per op. Driver-side bookkeeping
# (``core/sample.py`` original-space conversion, trace accessors) therefore
# uses these NumPy implementations; the math is identical.

def _np_prep(x, scales, bounds):
    dtype = np.dtype(get_dtype())
    x = np.asarray(x, dtype)
    lo = np.asarray(scales[:, 0], dtype)
    hi = np.asarray(scales[:, 1], dtype)
    b = normalize_bounds(bounds, scales.shape[0])
    return x, lo, hi - lo, b[:, 0], b[:, 1]


def np_from_original(x, scales, bounds):
    if scales is None:
        return np.asarray(x)
    x, lo, width, has_lo, has_hi = _np_prep(x, scales, bounds)
    with np.errstate(divide='ignore', invalid='ignore'):
        t = (x - lo) / width
        y = np.where(has_lo & has_hi, np.log(t) - np.log1p(-t), t)
        y = np.where(has_lo & ~has_hi, np.log(t), y)
        y = np.where(~has_lo & has_hi, np.log1p(-t), y)
    return y


def np_from_original_grad(x, scales, bounds):
    if scales is None:
        return np.ones_like(np.asarray(x))
    x, lo, width, has_lo, has_hi = _np_prep(x, scales, bounds)
    with np.errstate(divide='ignore', invalid='ignore'):
        t = (x - lo) / width
        g = np.where(has_lo & has_hi, 1.0 / (t * (1.0 - t)),
                     np.ones_like(t))
        g = np.where(has_lo & ~has_hi, 1.0 / t, g)
        g = np.where(~has_lo & has_hi, 1.0 / (t - 1.0), g)
    return g / width


def np_from_original_grad2(x, scales, bounds):
    if scales is None:
        return np.zeros_like(np.asarray(x))
    x, lo, width, has_lo, has_hi = _np_prep(x, scales, bounds)
    with np.errstate(divide='ignore', invalid='ignore'):
        t = (x - lo) / width
        omt = 1.0 - t
        g = np.where(has_lo & has_hi, (2.0 * t - 1.0) / (t * t * omt * omt),
                     np.zeros_like(t))
        g = np.where(has_lo & ~has_hi, -1.0 / (t * t), g)
        g = np.where(~has_lo & has_hi, 1.0 / ((t - 1.0) * omt), g)
    return g / (width * width)


def np_to_original(x, scales, bounds):
    if scales is None:
        return np.asarray(x)
    x, lo, width, has_lo, has_hi = _np_prep(x, scales, bounds)
    with np.errstate(over='ignore'):
        t = np.where(has_lo & has_hi, 1.0 / (1.0 + np.exp(-x)), x)
        t = np.where(has_lo & ~has_hi, np.exp(np.where(
            has_lo & ~has_hi, x, 0.0)), t)
        t = np.where(~has_lo & has_hi, 1.0 - np.exp(np.where(
            ~has_lo & has_hi, x, 0.0)), t)
    return lo + t * width


def np_to_original_grad(x, scales, bounds):
    if scales is None:
        return np.ones_like(np.asarray(x))
    x, lo, width, has_lo, has_hi = _np_prep(x, scales, bounds)
    with np.errstate(over='ignore'):
        sig = 1.0 / (1.0 + np.exp(-x))
        one_sided = (has_lo ^ has_hi)
        ex = np.exp(np.where(one_sided, x, 0.0))
        g = np.where(has_lo & has_hi, sig * (1.0 - sig), np.ones_like(x))
        g = np.where(has_lo & ~has_hi, ex, g)
        g = np.where(~has_lo & has_hi, -ex, g)
    return g * width


def np_to_original_grad2(x, scales, bounds):
    if scales is None:
        return np.zeros_like(np.asarray(x))
    x, lo, width, has_lo, has_hi = _np_prep(x, scales, bounds)
    with np.errstate(over='ignore'):
        one_sided = (has_lo ^ has_hi)
        ex = np.exp(np.where(one_sided | (has_lo & has_hi), x, 0.0))
        g = np.where(has_lo & has_hi,
                     -ex * (ex - 1.0) / ((ex + 1.0) ** 3),
                     np.zeros_like(x))
        g = np.where(has_lo & ~has_hi, ex, g)
        g = np.where(~has_lo & has_hi, -ex, g)
    return g * width


def to_original_with_logdet(x, scales, bounds):
    """Fused ``(to_original(x), log|det d to_original/dx|)``.

    Matches ``to_original`` + ``sum(log(abs(to_original_grad)))`` exactly,
    with minimal transcendental count and a rational custom JVP — the
    sampling-space density hot path (reference semantics
    ``bayesfast/core/density.py:747-750``).
    """
    dtype = get_dtype()
    if scales is None:
        x = jnp.asarray(x, dtype)
        return x, jnp.zeros(x.shape[:-1], dtype)
    x, lo, width, has_lo, has_hi = _prep(x, scales, bounds)
    m_lohi = (has_lo & has_hi).astype(dtype)
    m_lo = (has_lo & ~has_hi).astype(dtype)
    m_hi = (~has_lo & has_hi).astype(dtype)
    # constant part of the logdet: every branch's |g| carries a factor
    # |width| (the unbounded branch is an affine rescale), so the sum of
    # log|width| over ALL dims folds to one scalar at trace time
    # (scales/bounds are host numpy)
    w_np = scales[:, 1] - scales[:, 0]
    logw = float(np.sum(np.log(np.abs(w_np))))
    return _fused_to_original(x, lo, width, m_lohi, m_lo, m_hi,
                              jnp.asarray(logw, dtype))
