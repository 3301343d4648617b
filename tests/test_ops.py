"""Unit tests for the numerics substrate (splines, tridiag, Bessel)."""

import numpy as np
import pytest
import scipy.interpolate
import scipy.special
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.ops.tridiag import thomas_solve
from emri_frequencydomainwaveforms_tpu.ops.cubic_spline import (
    CubicSplineInterpolant,
    fit_cubic_spline,
    spline_eval,
)
from emri_frequencydomainwaveforms_tpu.ops.bessel import bessel_jn, kve_one_third


class TestTridiag:
    def test_matches_dense_solve(self):
        rng = np.random.default_rng(0)
        n = 37
        dl = rng.standard_normal(n)
        d = rng.standard_normal(n) + 5.0  # diagonally dominant
        du = rng.standard_normal(n)
        b = rng.standard_normal(n)
        a = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
        expect = np.linalg.solve(a, b)
        got = thomas_solve(jnp.array(dl), jnp.array(d), jnp.array(du), jnp.array(b))
        np.testing.assert_allclose(np.asarray(got), expect, rtol=1e-10)

    def test_batched(self):
        rng = np.random.default_rng(1)
        n, batch = 16, 5
        dl = rng.standard_normal((batch, n))
        d = rng.standard_normal((batch, n)) + 6.0
        du = rng.standard_normal((batch, n))
        b = rng.standard_normal((batch, n))
        got = np.asarray(thomas_solve(jnp.array(dl), jnp.array(d), jnp.array(du), jnp.array(b)))
        for i in range(batch):
            a = np.diag(d[i]) + np.diag(dl[i, 1:], -1) + np.diag(du[i, :-1], 1)
            np.testing.assert_allclose(got[i], np.linalg.solve(a, b[i]), rtol=1e-9)


class TestCubicSpline:
    def test_natural_matches_scipy(self):
        x = np.sort(np.random.default_rng(2).uniform(0, 10, 40))
        y = np.sin(x) + 0.1 * x**2
        ref = scipy.interpolate.CubicSpline(x, y, bc_type="natural")
        sp = fit_cubic_spline(jnp.array(x), jnp.array(y))
        xq = np.linspace(x[0], x[-1], 500)
        np.testing.assert_allclose(np.asarray(spline_eval(sp, jnp.array(xq))), ref(xq), atol=1e-10)
        np.testing.assert_allclose(
            np.asarray(spline_eval(sp, jnp.array(xq), deriv=1)), ref(xq, 1), atol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(spline_eval(sp, jnp.array(xq), deriv=2)), ref(xq, 2), atol=1e-8
        )

    def test_not_a_knot_matches_scipy(self):
        x = np.linspace(0.0, 4.0, 25)
        y = np.cos(2 * x) * np.exp(-0.1 * x)
        ref = scipy.interpolate.CubicSpline(x, y)  # scipy default = not-a-knot
        sp = fit_cubic_spline(jnp.array(x), jnp.array(y), bc="not-a-knot")
        xq = np.linspace(0, 4, 333)
        np.testing.assert_allclose(np.asarray(spline_eval(sp, jnp.array(xq))), ref(xq), atol=1e-9)

    def test_batched_interpolant_api(self):
        # pins the (ninterps, length) contract of the reference interpolant
        t = np.linspace(0, 1, 30)
        y = np.stack([np.sin(5 * t), np.cos(5 * t)])
        interp = CubicSplineInterpolant(t, y)
        t_new = np.linspace(0, 1, 100)
        out = np.asarray(interp(t_new))
        assert out.shape == (2, 100)
        np.testing.assert_allclose(out[0], np.sin(5 * t_new), atol=2e-3)

    def test_jit_and_vmap(self):
        t = jnp.linspace(0, 1, 20)
        ys = jnp.sin(jnp.arange(1, 4)[:, None] * t[None, :] * 3)

        @jax.jit
        def f(y):
            sp = fit_cubic_spline(t, y)
            return spline_eval(sp, jnp.linspace(0, 1, 50))

        out = jax.vmap(f)(ys)
        assert out.shape == (3, 50)
        assert np.isfinite(np.asarray(out)).all()


class TestBessel:
    def test_kve_imaginary_axis(self):
        # the SPA correction evaluates K_{1/3} on the imaginary axis
        mags = np.concatenate([np.linspace(0.01, 8, 60), np.logspace(1, 4, 20)])
        for sign in (+1.0, -1.0):
            z = sign * 1j * mags
            expect = scipy.special.kv(1.0 / 3.0, z) * np.exp(z)
            got = np.asarray(kve_one_third(jnp.array(z)))
            np.testing.assert_allclose(got, expect, rtol=1e-7, atol=1e-12)

    def test_kve_real_axis(self):
        x = np.concatenate([np.linspace(0.05, 5, 40), np.linspace(10, 30, 20)])
        expect = scipy.special.kve(1.0 / 3.0, x)
        got = np.asarray(kve_one_third(jnp.array(x + 0j)))
        np.testing.assert_allclose(got.real, expect, rtol=1e-6)

    def test_bessel_jn(self):
        x = np.array([0.0, 0.3, 1.7, 5.2, 11.0])
        got = np.asarray(bessel_jn(8, jnp.array(x)))
        for n in range(9):
            np.testing.assert_allclose(got[n], scipy.special.jv(n, x), atol=1e-10)

    def test_kve_imag_real_pair(self):
        # real-arithmetic path matches the complex implementation / scipy
        w = np.concatenate([-np.logspace(-2, 4, 40), np.logspace(-2, 4, 40)])
        expect = scipy.special.kv(1.0 / 3.0, 1j * w) * np.exp(1j * w)
        from emri_frequencydomainwaveforms_tpu.ops.bessel import kve_one_third_imag
        re, im = kve_one_third_imag(jnp.array(w))
        got = np.asarray(re) + 1j * np.asarray(im)
        np.testing.assert_allclose(got, expect, rtol=1e-7, atol=1e-12)
