"""Batched natural cubic splines, fully jittable / vmappable.

JAX equivalent of the reference engine's
``few.summation.interpolatedmodesum.CubicSplineInterpolant`` (CUDA/cuSPARSE
upstream; behavior pinned by reference ``Tutorial_FD_construction_single_mode.ipynb``
cells 8-9 and 20-21: fit at sparse trajectory knots with shape
``(ninterps, length)``, then evaluate at arbitrary new abscissae) and of the
``scipy.interpolate.CubicSpline`` usage in the same notebook (cells 11-17:
derivative splines for f(t), fdot, fddot).

Design: a spline is a small pytree of coefficients; fitting is a batched
tridiagonal solve (`ops.tridiag.thomas_solve`), evaluation is a vectorized
searchsorted + gather + Horner polynomial — all static-shape, so the whole
waveform pipeline stays inside one `jit`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .tridiag import thomas_solve


class CubicSplineCoeffs(NamedTuple):
    """Piecewise-cubic coefficients.

    ``y(t) = c0 + c1*dx + c2*dx^2 + c3*dx^3`` with ``dx = t - x[j]`` on
    segment ``j``.

    Attributes:
      x: knots, shape ``(n,)`` (shared across the batch).
      c: coefficients, shape ``(..., n-1, 4)`` ordered ``(c0, c1, c2, c3)``.
    """

    x: jax.Array
    c: jax.Array

    @property
    def num_segments(self) -> int:
        return self.c.shape[-2]


def fit_cubic_spline(x: jax.Array, y: jax.Array, bc: str = "natural") -> CubicSplineCoeffs:
    """Fit a (batch of) cubic spline(s) through ``(x, y)``.

    Solves for the knot slopes ``s_i`` (Hermite form), which keeps both
    boundary conditions strictly tridiagonal (no zero pivots on uniform
    grids, unlike the moments form with eliminated not-a-knot rows).

    Args:
      x: strictly increasing knots ``(n,)``.
      y: values ``(..., n)``; leading axes are independent splines.
      bc: "natural" (zero second derivative at both ends) or "not-a-knot".

    Returns:
      CubicSplineCoeffs with ``c`` of shape ``(..., n-1, 4)``.
    """
    n = x.shape[-1]
    h = jnp.diff(x)  # (n-1,)
    slope = jnp.diff(y, axis=-1) / h  # (..., n-1)
    batch = y.shape[:-1]

    # Interior rows i = 1..n-2:
    #   h[i] s[i-1] + 2 (h[i-1] + h[i]) s[i] + h[i-1] s[i+1]
    #     = 3 (h[i] slope[i-1] + h[i-1] slope[i])
    dl_int = h[1:]
    d_int = 2.0 * (h[:-1] + h[1:])
    du_int = h[:-1]
    rhs_int = 3.0 * (h[1:] * slope[..., :-1] + h[:-1] * slope[..., 1:])

    one = jnp.ones((1,), x.dtype)
    zero = jnp.zeros((1,), x.dtype)

    if bc == "natural":
        # y'' = 0 at the ends: 2 s_0 + s_1 = 3 slope_0 ;
        #                      s_{n-2} + 2 s_{n-1} = 3 slope_{n-2}
        d0, du0 = 2.0 * one, one
        b0 = 3.0 * slope[..., 0:1]
        dN, dlN = 2.0 * one, one
        bN = 3.0 * slope[..., -1:]
    elif bc == "not-a-knot":
        if n < 4:
            return fit_cubic_spline(x, y, bc="natural")
        # scipy-equivalent not-a-knot boundary rows (third-derivative
        # continuity at the first/last interior knots), tridiagonal form.
        h0, h1 = h[0], h[1]
        hm1, hm2 = h[-1], h[-2]
        x20 = h0 + h1
        xm20 = hm1 + hm2
        d0 = h1[None]
        du0 = x20[None]
        b0 = ((h0 + 2.0 * x20) * h1 * slope[..., 0:1] + h0**2 * slope[..., 1:2]) / x20
        dN = hm2[None]
        dlN = xm20[None]
        bN = (hm1**2 * slope[..., -2:-1] + (2.0 * xm20 + hm1) * hm2 * slope[..., -1:]) / xm20
    else:
        raise ValueError(f"unknown bc {bc!r}")

    dl = jnp.concatenate([zero, dl_int, dlN])
    d = jnp.concatenate([d0, d_int, dN])
    du = jnp.concatenate([du0, du_int, zero])
    rhs = jnp.concatenate([b0, rhs_int, bN], axis=-1)

    s = thomas_solve(
        jnp.broadcast_to(dl, batch + (n,)),
        jnp.broadcast_to(d, batch + (n,)),
        jnp.broadcast_to(du, batch + (n,)),
        rhs,
    )

    s_lo = s[..., :-1]
    s_hi = s[..., 1:]
    c0 = y[..., :-1]
    c1 = s_lo
    c2 = (3.0 * slope - 2.0 * s_lo - s_hi) / h
    c3 = (s_lo + s_hi - 2.0 * slope) / h**2
    c = jnp.stack([c0, c1, c2, c3], axis=-1)  # (..., n-1, 4)
    return CubicSplineCoeffs(x=x, c=c)


def _segment_index(x: jax.Array, xq: jax.Array) -> jax.Array:
    """Index of the segment containing each query (clamped to valid range)."""
    idx = jnp.searchsorted(x, xq, side="right") - 1
    return jnp.clip(idx, 0, x.shape[-1] - 2)


def spline_eval(sp: CubicSplineCoeffs, xq: jax.Array, deriv: int = 0) -> jax.Array:
    """Evaluate the spline (or its 1st/2nd derivative) at query points.

    Args:
      sp: fitted coefficients, ``c`` shape ``(..., n-1, 4)``.
      xq: query points, shape ``(m,)`` (or any shape; flattened semantics).

    Returns:
      values of shape ``batch + xq.shape``.
    """
    j = _segment_index(sp.x, xq)
    dx = xq - jnp.take(sp.x, j)
    cj = jnp.take(sp.c, j, axis=-2)  # (..., *xq.shape, 4)
    c0, c1, c2, c3 = cj[..., 0], cj[..., 1], cj[..., 2], cj[..., 3]
    if deriv == 0:
        return c0 + dx * (c1 + dx * (c2 + dx * c3))
    if deriv == 1:
        return c1 + dx * (2.0 * c2 + 3.0 * dx * c3)
    if deriv == 2:
        return 2.0 * c2 + 6.0 * dx * c3
    if deriv == 3:
        return 6.0 * c3 + jnp.zeros_like(dx)
    raise ValueError("deriv must be 0, 1, 2 or 3")


def spline_eval_at_segments(
    sp: CubicSplineCoeffs, j: jax.Array, xq: jax.Array, deriv: int = 0
) -> jax.Array:
    """Evaluate with precomputed segment indices (skips the searchsorted)."""
    dx = xq - jnp.take(sp.x, j)
    cj = jnp.take(sp.c, j, axis=-2)
    c0, c1, c2, c3 = cj[..., 0], cj[..., 1], cj[..., 2], cj[..., 3]
    if deriv == 0:
        return c0 + dx * (c1 + dx * (c2 + dx * c3))
    if deriv == 1:
        return c1 + dx * (2.0 * c2 + 3.0 * dx * c3)
    return 2.0 * c2 + 6.0 * dx * c3


class CubicSplineInterpolant:
    """Thin OO facade matching the reference engine's interpolant API.

    Reference contract (``Tutorial_FD_construction_single_mode.ipynb`` cells
    8-9, 20-21): construct with ``(t, y)`` where ``y`` is ``(ninterps, length)``
    or ``(length,)``; call with new times to get interpolated values of shape
    ``(ninterps, m)``. Purely a convenience wrapper over the functional API.
    """

    def __init__(self, t, y, bc: str = "natural"):
        t = jnp.asarray(t)
        y = jnp.asarray(y)
        self.coeffs = fit_cubic_spline(t, y, bc=bc)

    def __call__(self, t_new, deriv: int = 0):
        return spline_eval(self.coeffs, jnp.asarray(t_new), deriv=deriv)


__all__ = [
    "CubicSplineCoeffs",
    "fit_cubic_spline",
    "spline_eval",
    "spline_eval_at_segments",
    "CubicSplineInterpolant",
]
