"""Constraint-transform derivative tests vs autodiff ground truth
(reference: ``bayesfast/tests/test_constraint.py`` uses numdifftools)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesfast_jax.ops import constraint as con

BOUND_CASES = [[False, False], [False, True], [True, False], [True, True]]


@pytest.mark.parametrize('hb', BOUND_CASES)
def test_from_original_grads(hb):
    scales = con.normalize_scales(np.array([[-2.0, 3.0]]))
    bounds = np.array([hb])
    x = np.linspace(-1.5, 2.5, 11).reshape(-1, 1)

    f = lambda v: con.from_original(v, scales, bounds)[0]
    for xi in x:
        g_auto = jax.grad(f)(jnp.asarray(xi))
        g = con.from_original_grad(xi, scales, bounds)
        assert np.allclose(np.asarray(g), np.asarray(g_auto), rtol=1e-6)
        g2_auto = jax.grad(lambda v: jax.grad(f)(v)[0])(jnp.asarray(xi))
        g2 = con.from_original_grad2(xi, scales, bounds)
        assert np.allclose(np.asarray(g2), np.asarray(g2_auto), rtol=1e-6)


@pytest.mark.parametrize('hb', BOUND_CASES)
def test_to_original_grads(hb):
    scales = con.normalize_scales(np.array([[-2.0, 3.0]]))
    bounds = np.array([hb])
    x = np.linspace(-2.0, 2.0, 11).reshape(-1, 1)

    f = lambda v: con.to_original(v, scales, bounds)[0]
    for xi in x:
        g_auto = jax.grad(f)(jnp.asarray(xi))
        g = con.to_original_grad(xi, scales, bounds)
        assert np.allclose(np.asarray(g), np.asarray(g_auto), rtol=1e-6)
        g2_auto = jax.grad(lambda v: jax.grad(f)(v)[0])(jnp.asarray(xi))
        g2 = con.to_original_grad2(xi, scales, bounds)
        assert np.allclose(np.asarray(g2), np.asarray(g2_auto), rtol=1e-6)


@pytest.mark.parametrize('hb', BOUND_CASES)
def test_round_trip(hb):
    scales = con.normalize_scales(np.array([[0.0, 1.0], [-5.0, 2.0]]))
    bounds = np.array([hb, hb])
    x = np.array([[0.3, -1.0], [0.9, 1.5]])
    y = con.from_original(x, scales, bounds)
    x2 = con.to_original(y, scales, bounds)
    assert np.allclose(np.asarray(x2), x, rtol=1e-10)


def test_mixed_bounds_vector():
    scales = con.normalize_scales(
        np.array([[0.0, 1.0], [0.0, 1.0], [0.0, 1.0], [0.0, 1.0]]))
    bounds = np.array(BOUND_CASES)
    x = np.full(4, 0.25)
    y = np.asarray(con.from_original(x, scales, bounds))
    # none / upper / lower / both
    assert np.isclose(y[0], 0.25)
    assert np.isclose(y[1], np.log(0.75))
    assert np.isclose(y[2], np.log(0.25))
    assert np.isclose(y[3], np.log(0.25 / 0.75))


def test_fused_to_original_with_logdet():
    """The fused transform (one exp + one log + rational custom JVP — the
    sampler hot path) must match the composed to_original +
    sum(log|to_original_grad|) in value AND gradient on every bound
    combination."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    D = 8
    scales = con.normalize_scales(
        np.stack([np.full(D, -2.0), np.full(D, 3.0)]).T)
    bounds = np.array((BOUND_CASES * 2)[:D], bool)
    x = rng.normal(size=(5, D))

    xo_ref = np.asarray(con.to_original(x, scales, bounds))
    ld_ref = np.sum(np.log(np.abs(np.asarray(
        con.to_original_grad(x, scales, bounds)))), axis=-1)
    xo, ld = con.to_original_with_logdet(x, scales, bounds)
    assert np.allclose(np.asarray(xo), xo_ref, atol=1e-12)
    assert np.allclose(np.asarray(ld), ld_ref, atol=1e-12)

    def f_fused(u):
        xo, ld = con.to_original_with_logdet(u, scales, bounds)
        return jnp.sum(jnp.sin(xo)) + jnp.sum(ld)

    def f_composed(u):
        xo = con.to_original(u, scales, bounds)
        g = con.to_original_grad(u, scales, bounds)
        return (jnp.sum(jnp.sin(xo))
                + jnp.sum(jnp.log(jnp.abs(g))))

    g_new = jax.grad(f_fused)(jnp.asarray(x[0]))
    g_old = jax.grad(f_composed)(jnp.asarray(x[0]))
    assert np.allclose(np.asarray(g_new), np.asarray(g_old), atol=1e-11)

    # unbounded fall-through
    xo, ld = con.to_original_with_logdet(x, None, False)
    assert np.allclose(np.asarray(xo), x)
    assert np.allclose(np.asarray(ld), 0.0)


def test_fused_logdet_extreme_x_float32():
    """Round-4 advisor regression: with arithmetic branch masking,
    exp(x) overflowed to inf at x > ~88.7 in float32 and 0*inf NaN-poisoned
    unbounded dims. The fused transform must stay exact and finite at
    |x| ~ 100 wherever the unfused path is."""
    from bayesfast_jax import config

    old = config.get_dtype()
    config.set_dtype(jnp.float32)
    try:
        D = 4
        scales = con.normalize_scales(
            np.stack([np.full(D, -2.0), np.full(D, 3.0)]).T)
        # one dim per bound combination: none, upper, lower, both
        bounds = np.array(BOUND_CASES, bool)
        for xval in (100.0, -100.0, 0.5):
            x = np.full((D,), xval)
            xo, ld = con.to_original_with_logdet(x, scales, bounds)
            xo_ref = np.asarray(con.to_original(x, scales, bounds))
            xo = np.asarray(xo)
            # never NaN (the round-4 0*inf poisoning), anywhere
            assert not np.any(np.isnan(xo))
            assert not np.isnan(ld)
            # unbounded + both-bounds dims are always finite
            assert np.isfinite(xo[0]) and np.isfinite(xo[3])
            np.testing.assert_allclose(xo[np.isfinite(xo_ref)],
                                       xo_ref[np.isfinite(xo_ref)],
                                       rtol=1e-6)
            # float64 analytic logdet per dim: none 0; one-sided
            # x + log(w); two-sided log(s(1-s)w). The fused f32 value is
            # exact on one-sided dims at ANY |x| (log|exp(x)| == x
            # analytically); the two-sided dim saturates at the exp-clamp
            # (|bias| <= ~|x| - 85) or at -inf where even the clamped
            # s(1-s) underflows f32 (x >> 0) — matching the unfused f32
            # path's own saturation there.
            w = 5.0
            ld_true = (np.log(w)              # unbounded: affine rescale
                       + (xval + np.log(w)) * 2
                       + (-np.abs(xval) - 2 * np.log1p(np.exp(-np.abs(
                           xval))) + np.log(w)))
            tol = (abs(xval) - 80.0) if abs(xval) > 85 else 1e-4
            if np.isfinite(ld):
                assert abs(float(ld) - ld_true) <= tol
            # gradient must be nan-free on the finite side
            def f(u):
                xo, ld = con.to_original_with_logdet(u, scales, bounds)
                return jnp.sum(xo * jnp.isfinite(xo)) + \
                    jnp.where(jnp.isfinite(ld), ld, 0.0)
            g = np.asarray(jax.grad(f)(jnp.asarray(x, jnp.float32)))
            assert np.isfinite(g[0])  # unbounded dim: never NaN
    finally:
        config.set_dtype(old)


def test_numpy_host_twins_match_device():
    """The NumPy host-path transforms (used for driver-side trace
    bookkeeping) must match the jnp device versions exactly on every
    bound combination."""
    rng = np.random.default_rng(9)
    D = 8
    scales = con.normalize_scales(
        np.stack([np.full(D, -2.0), np.full(D, 3.0)]).T)
    bounds = np.array((BOUND_CASES * 2)[:D], bool)
    x_t = rng.normal(size=(7, D))              # transformed space
    x_o = np.asarray(con.to_original(x_t, scales, bounds))  # original space

    pairs = [
        (con.np_to_original, con.to_original, x_t),
        (con.np_to_original_grad, con.to_original_grad, x_t),
        (con.np_to_original_grad2, con.to_original_grad2, x_t),
        (con.np_from_original, con.from_original, x_o),
        (con.np_from_original_grad, con.from_original_grad, x_o),
        (con.np_from_original_grad2, con.from_original_grad2, x_o),
    ]
    for f_np, f_j, arg in pairs:
        a = np.asarray(f_np(arg, scales, bounds))
        b = np.asarray(f_j(arg, scales, bounds))
        np.testing.assert_allclose(a, b, rtol=5e-6, atol=1e-12)
        # unbounded fall-through
        a0 = np.asarray(f_np(arg, None, False))
        b0 = np.asarray(f_j(arg, None, False))
        np.testing.assert_allclose(a0, b0, rtol=5e-6)
