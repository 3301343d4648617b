"""Jittable Bessel functions needed by the FD stationary-phase kernel.

The reference's FD construction applies an Airy-type correction near the
stationary-phase turnover using ``scipy.special.kv(1/3, arg) * exp(arg)`` with
a purely imaginary ``arg = -2*pi*i*fdot^3/(3*fddot^2)`` (reference
``Tutorial_FD_construction_single_mode.ipynb`` cell 26). scipy is not jittable
and XLA has no complex Bessel primitive, so we implement the scaled modified
Bessel ``K_{1/3}(z) e^z`` directly:

* small ``|z|``: ascending series through ``I_{+-1/3}``,
  ``K_nu = pi/2 * (I_{-nu} - I_{nu}) / sin(nu*pi)``;
* large ``|z|``: Poincare asymptotic series for ``K_nu(z) e^z``;
* selection at ``|z| ~ 8``. On the imaginary axis (the only place the SPA
  correction evaluates) worst-case relative error is ~2.5e-8 at the switch
  point (the asymptotic series' optimal-truncation floor) and <1e-11
  elsewhere — ~4 orders below the 1e-4 mismatch gate.

Valid on the principal branch ``|arg z| < pi`` which covers the imaginary
axis where the SPA correction lives.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

_NU = 1.0 / 3.0
_SERIES_TERMS = 30
_ASYMP_TERMS = 12
_SWITCH = 8.0

# Host-side constants: 1 / Gamma(k + 1 +- nu) / k!
_INV_GAMMA_P = [1.0 / (math.gamma(k + 1.0 + _NU) * math.factorial(k)) for k in range(_SERIES_TERMS)]
_INV_GAMMA_M = [1.0 / (math.gamma(k + 1.0 - _NU) * math.factorial(k)) for k in range(_SERIES_TERMS)]

# Asymptotic coefficients a_k(nu): a_0 = 1,
# a_k = a_{k-1} * (4 nu^2 - (2k-1)^2) / (8 k)
_ASYMP_COEF = [1.0]
for _k in range(1, _ASYMP_TERMS):
    _ASYMP_COEF.append(_ASYMP_COEF[-1] * (4.0 * _NU**2 - (2.0 * _k - 1.0) ** 2) / (8.0 * _k))


def _kve_small(z: jax.Array) -> jax.Array:
    """K_{1/3}(z) e^z by ascending series (accurate for |z| <~ 6)."""
    q = 0.25 * z * z  # (z/2)^2
    # sum_k q^k / (k! Gamma(k+1+-nu)) via Horner in q
    s_p = jnp.full_like(z, _INV_GAMMA_P[-1])
    s_m = jnp.full_like(z, _INV_GAMMA_M[-1])
    for k in range(_SERIES_TERMS - 2, -1, -1):
        s_p = s_p * q + _INV_GAMMA_P[k]
        s_m = s_m * q + _INV_GAMMA_M[k]
    half_z_nu = jnp.exp(_NU * jnp.log(0.5 * z))  # principal branch
    i_p = half_z_nu * s_p
    i_m = s_m / half_z_nu
    k_nu = (math.pi / 2.0) / math.sin(_NU * math.pi) * (i_m - i_p)
    return k_nu * jnp.exp(z)


def _kve_large(z: jax.Array) -> jax.Array:
    """K_{1/3}(z) e^z by the Poincare asymptotic expansion (|z| >~ 4)."""
    inv_z = 1.0 / z
    s = jnp.full_like(z, _ASYMP_COEF[-1])
    for k in range(_ASYMP_TERMS - 2, -1, -1):
        s = s * inv_z + _ASYMP_COEF[k]
    return jnp.sqrt(math.pi / 2.0 * inv_z) * s


def kve_one_third(z: jax.Array) -> jax.Array:
    """Scaled modified Bessel ``K_{1/3}(z) * exp(z)`` for complex ``z``.

    Matches ``scipy.special.kv(1/3, z) * exp(z)`` on the principal branch.
    """
    z = jnp.asarray(z, dtype=jnp.complex128 if z.dtype in (jnp.complex128, jnp.float64) else jnp.complex64)
    absz = jnp.abs(z)
    small = absz < _SWITCH
    # Guard each branch's argument so the unselected lane can't overflow.
    z_small = jnp.where(small, z, jnp.asarray(_SWITCH, z.dtype))
    z_large = jnp.where(small, jnp.asarray(_SWITCH, z.dtype), z)
    return jnp.where(small, _kve_small(z_small), _kve_large(z_large))


def kve_one_third_imag(w: jax.Array) -> tuple[jax.Array, jax.Array]:
    """``K_{1/3}(i w) * exp(i w)`` for real ``w``, in real arithmetic.

    The production FD kernel calls this real-pair specialization (real
    arithmetic throughout, ROADMAP Design item 3): the SPA
    correction argument ``-2*pi*i*fdot^3/(3*fddot^2)`` is purely imaginary,
    ``z = i w``. Returns ``(re, im)`` as float arrays matching ``w``.

    For ``z = i w``: the ascending-series variable ``q = z^2/4 = -w^2/4`` is
    real, so both ``I_{+-1/3}`` sums are real Horner evaluations; only the
    prefactors ``(z/2)^{+-1/3}`` and ``e^z`` are complex phases. The
    asymptotic branch's ``1/z`` powers cycle through ``{1, -i, -1, i}/w^k``.
    """
    w = jnp.asarray(w)
    aw = jnp.abs(w)
    sgn = jnp.sign(w)
    small = aw < _SWITCH
    aw_small = jnp.where(small, aw, _SWITCH)
    aw_large = jnp.where(small, _SWITCH, aw)

    # --- small branch: ascending series, q real ---
    q = -0.25 * aw_small * aw_small
    s_p = jnp.full_like(q, _INV_GAMMA_P[-1])
    s_m = jnp.full_like(q, _INV_GAMMA_M[-1])
    for k in range(_SERIES_TERMS - 2, -1, -1):
        s_p = s_p * q + _INV_GAMMA_P[k]
        s_m = s_m * q + _INV_GAMMA_M[k]
    # (z/2)^nu = (w/2)^nu e^{i pi nu/2 * sgn};  prefix C = (pi/2)/sin(pi nu)
    r_nu = jnp.exp(_NU * jnp.log(0.5 * aw_small))
    c_nu, s_nu = math.cos(math.pi * _NU / 2.0), math.sin(math.pi * _NU / 2.0)
    # i_p = r_nu e^{i a} s_p ; i_m = (1/r_nu) e^{-i a} s_m with a = pi nu/2 sgn
    ip_re = r_nu * c_nu * s_p
    ip_im = r_nu * s_nu * sgn * s_p
    im_re = (1.0 / r_nu) * c_nu * s_m
    im_im = -(1.0 / r_nu) * s_nu * sgn * s_m
    pref = (math.pi / 2.0) / math.sin(_NU * math.pi)
    k_re = pref * (im_re - ip_re)
    k_im = pref * (im_im - ip_im)
    # multiply by e^{i w}
    cw, sw = jnp.cos(w), jnp.sin(w)
    small_re = k_re * cw - k_im * sw
    small_im = k_re * sw + k_im * cw

    # --- large branch: Poincare series in 1/z = -i sgn / |w| ---
    x2 = 1.0 / (aw_large * aw_large)
    # even terms a_0 - a_2/w^2 + a_4/w^4 ... (real), odd terms (imag, * -i sgn)
    n_even = (_ASYMP_TERMS + 1) // 2
    n_odd = _ASYMP_TERMS // 2
    se = jnp.full_like(x2, _ASYMP_COEF[2 * (n_even - 1)] * (-1.0) ** (n_even - 1))
    for j in range(n_even - 2, -1, -1):
        se = se * x2 + _ASYMP_COEF[2 * j] * (-1.0) ** j
    so = jnp.full_like(x2, _ASYMP_COEF[2 * (n_odd - 1) + 1] * (-1.0) ** (n_odd - 1))
    for j in range(n_odd - 2, -1, -1):
        so = so * x2 + _ASYMP_COEF[2 * j + 1] * (-1.0) ** j
    s_re = se
    s_im = -sgn * so / aw_large
    # sqrt(pi/(2 i w)) = sqrt(pi/(2|w|)) e^{-i pi/4 sgn}
    root = jnp.sqrt(math.pi / (2.0 * aw_large))
    c4 = math.cos(math.pi / 4.0)
    pre_re = root * c4
    pre_im = -root * c4 * sgn
    large_re = pre_re * s_re - pre_im * s_im
    large_im = pre_re * s_im + pre_im * s_re

    re = jnp.where(small, small_re, large_re)
    im = jnp.where(small, small_im, large_im)
    return re, im


def bessel_jn(n_max: int, x: jax.Array) -> jax.Array:
    """Bessel J_n(x) for n = 0..n_max via Miller's backward recurrence.

    Used for Peters-Mathews closed-form checks of the Newtonian eccentric
    harmonics (test-only; the production amplitude path Fourier-decomposes the
    orbit numerically). Returns shape ``(n_max+1,) + x.shape``.
    """
    x = jnp.asarray(x)
    m_start = n_max + 16 + int(1.5 * n_max)
    # backward recurrence J_{k-1} = (2k/x) J_k - J_{k+1}
    jp = jnp.zeros_like(x)
    jc = jnp.ones_like(x) * 1e-30
    out = [None] * (n_max + 1)
    norm = jnp.zeros_like(x)
    for k in range(m_start, 0, -1):
        jm = (2.0 * k / jnp.where(x == 0, 1.0, x)) * jc - jp
        jp, jc = jc, jm
        # renormalize to avoid overflow
        big = jnp.abs(jc) > 1e10
        scale = jnp.where(big, 1e-10, 1.0)
        jc = jc * scale
        jp = jp * scale
        norm = norm * scale
        if k - 1 <= n_max:
            out[k - 1] = jc
        if (k - 1) % 2 == 0 and k - 1 > 0:
            norm = norm + 2.0 * jc
        # rescale stored values too
        for i in range(len(out)):
            if out[i] is not None and i != k - 1:
                out[i] = out[i] * scale
    norm = norm + jc  # add J_0 once more? (norm = J_0 + 2*sum J_{2k})
    stacked = jnp.stack(out, axis=0)
    res = stacked / norm
    # exact x=0 limit
    n_idx = jnp.arange(n_max + 1).reshape((n_max + 1,) + (1,) * x.ndim)
    return jnp.where(x == 0, jnp.where(n_idx == 0, 1.0, 0.0), res)


__all__ = ["kve_one_third", "kve_one_third_imag", "bessel_jn"]
