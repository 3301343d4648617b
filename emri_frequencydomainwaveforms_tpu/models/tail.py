"""Relativistic tail correction for the multipole amplitudes.

The factorized-waveform tail factor (Damour, Iyer & Nagar 2009, eq. 19;
Bini & Damour 2012 for generic mode frequencies)

    T_lm(omega) = Gamma(l + 1 - 2 i khat) / Gamma(l + 1)
                  * exp(pi khat) * exp(2 i khat ln(2 |omega| r0)),
    khat = M omega   (geometric units, M = 1 here),

is the exact resummation of the leading *wave-tail* contributions: the
backscattering of the outgoing radiation off the Schwarzschild curvature
potential.  It is a genuinely relativistic, closed-form amplification of
each (l, m, n) harmonic — the first correction beyond the flat-space
multipole amplitudes in `models.amplitude` — with two independent
validation anchors that do NOT come from this repo's own brute force:

  * amplitude: |T_22| -> 1 + 2 pi x^{3/2} as x -> 0, the known 1.5PN
    tail term of the (2,2) PN amplitude (khat = 2 M Omega = 2 x^{3/2});
  * energy flux: |T_22|^2 -> 1 + 4 pi x^{3/2}, the celebrated 4 pi x^{3/2}
    wave-tail term of the PN GW flux (Poisson 1993).

Negative mode frequencies (omega_mn = m Omega_phi + n Omega_r < 0 for
sufficiently retrograde radial harmonics) get exp(pi khat) < 1 — the
physical suppression of negative-frequency Teukolsky modes.  The
equatorial partner symmetry A_{l,-m,-n} = (-1)^l conj(A_{l,m,n}) applied
by the kernels composes the stored m >= 0 modes only, so applying
T(omega_mn) to the stored half-plane is exact for the real strain.

Reference parity: the reference engine's RomanAmplitude network encodes
Teukolsky amplitudes whose tail content this factor reproduces at
leading transcendental order (`/root/reference/
Tutorial_FD_construction_single_mode.ipynb` cell 2).

Numerics: complex log-gamma by the g = 7, n = 9 Lanczos approximation
(double-precision accurate for Re z >= 1; here Re z = l + 1 >= 3),
implemented on (re, im) pairs — no complex dtype (ROADMAP Design item 3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Lanczos g = 7, n = 9 coefficients (Godfrey / Numerical Recipes lineage).
_LANCZOS_G = 7.0
_LANCZOS_C = np.array(
    [
        0.99999999999980993,
        676.5203681218851,
        -1259.1392167224028,
        771.32342877765313,
        -176.61502916214059,
        12.507343278686905,
        -0.13857109526572012,
        9.9843695780195716e-6,
        1.5056327351493116e-7,
    ]
)
_HALF_LOG_2PI = 0.5 * np.log(2.0 * np.pi)


def complex_lgamma(z_re: jax.Array, z_im: jax.Array) -> tuple[jax.Array, jax.Array]:
    """log Gamma(z) for Re z >= 1, on (re, im) pairs (principal branch).

    Lanczos: with w = z - 1, t = w + g + 1/2,
      lgamma(z) = log(2 pi)/2 + (w + 1/2) log t - t + log(sum_k c_k s_k)
    where s_0 = 1, s_k = 1/(w + k).
    """
    w_re = z_re - 1.0
    w_im = z_im

    s_re = jnp.full_like(w_re, _LANCZOS_C[0])
    s_im = jnp.zeros_like(w_re)
    for k in range(1, _LANCZOS_C.shape[0]):
        d_re = w_re + float(k)
        d_im = w_im
        inv = 1.0 / (d_re * d_re + d_im * d_im)
        s_re = s_re + _LANCZOS_C[k] * d_re * inv
        s_im = s_im - _LANCZOS_C[k] * d_im * inv

    t_re = w_re + (_LANCZOS_G + 0.5)
    t_im = w_im
    log_t_re = 0.5 * jnp.log(t_re * t_re + t_im * t_im)
    log_t_im = jnp.arctan2(t_im, t_re)

    # (w + 1/2) * log t
    a_re = w_re + 0.5
    prod_re = a_re * log_t_re - w_im * log_t_im
    prod_im = a_re * log_t_im + w_im * log_t_re

    log_s_re = 0.5 * jnp.log(s_re * s_re + s_im * s_im)
    log_s_im = jnp.arctan2(s_im, s_re)

    return (
        _HALF_LOG_2PI + prod_re - t_re + log_s_re,
        prod_im - t_im + log_s_im,
    )


def tail_factor(
    ls: np.ndarray | jax.Array,
    omega: jax.Array,
    r0: float = 2.0,
) -> tuple[jax.Array, jax.Array]:
    """Complex T_lm(omega) on (re, im) pairs; broadcasts over ``omega``.

    ``ls``: static integer l per mode (last axis); ``omega``: mode
    frequencies M omega_mn (any sign).  ``r0``: the tail gauge constant in
    units of M (enters only through a frequency-log phase; r0 = 2M is the
    Schwarzschild light-ring-scale convention).  Returns T with |T| -> 1
    and arg T -> 0 as omega -> 0.
    """
    ls_f = jnp.asarray(np.asarray(ls, np.float64))
    khat = omega  # M = 1 units
    two_k = 2.0 * khat

    lg_re, lg_im = complex_lgamma(ls_f + 1.0, -two_k)
    # log Gamma(l+1) (real): via the same Lanczos for exact cancellation
    lg0_re, _ = complex_lgamma(ls_f + 1.0, jnp.zeros_like(ls_f))

    # log |T| and arg T
    abs_omega = jnp.maximum(jnp.abs(omega), 1.0e-300)
    log_mod = lg_re - lg0_re + jnp.pi * khat
    phase = lg_im + two_k * jnp.log(2.0 * abs_omega * r0)

    mod = jnp.exp(log_mod)
    return mod * jnp.cos(phase), mod * jnp.sin(phase)


def tail_modulus_sq(ls: np.ndarray | jax.Array, omega: jax.Array) -> jax.Array:
    """|T_lm|^2 in closed form (no Lanczos) — the flux tail weight.

      |T|^2 = prod_{j=1..l} (j^2 + 4 khat^2) / (l!)^2
              * 4 pi khat / (1 - exp(-4 pi khat)),

    evaluated with the exact khat -> 0 limit (= 1).  Used by the
    multipole flux (`models.flux.flux_from_modes(tail=True)`) and as an
    independent cross-check of the Lanczos path in tests.
    """
    ls_np = np.asarray(ls, np.int64)
    khat = omega
    k2_4 = 4.0 * khat * khat

    l_max = int(ls_np.max()) if ls_np.size else 2
    prod = jnp.ones_like(khat)
    run = jnp.ones_like(khat)
    fact_sq = np.ones(ls_np.shape)
    running_fact = np.ones(ls_np.shape)
    for j in range(1, l_max + 1):
        run = run * (float(j * j) + k2_4)
        running_fact = running_fact * j
        use = ls_np >= j
        prod = jnp.where(jnp.asarray(use), run, prod)
        fact_sq = np.where(use, running_fact, fact_sq)
    prod = prod / jnp.asarray(fact_sq * fact_sq)

    x = 4.0 * jnp.pi * khat
    # x / (1 - e^-x), stable at x -> 0 via expm1
    small = jnp.abs(x) < 1.0e-12
    x_safe = jnp.where(small, 1.0, x)
    geom = jnp.where(small, 1.0 + x / 2.0, x_safe / (-jnp.expm1(-x_safe)))
    return prod * geom


__all__ = ["complex_lgamma", "tail_factor", "tail_modulus_sq"]
