"""Schwarzschild eccentric geodesics: energy, angular momentum, frequencies.

JAX replacement for the reference engine's C++ utilities
``get_fundamental_frequencies`` / ``get_separatrix`` (behavior pinned at
reference ``Tutorial_FD_construction_single_mode.ipynb`` cells 11-15 and 26:
``OmegaPhi, OmegaTheta, OmegaR = get_fundamental_frequencies(0., p, e, 0.)``
with ``f_mn = (m OmegaPhi + n OmegaR) / (2 pi M MTSUN_SI)``).

Everything is in geometric units with the central mass M = 1; frequencies are
dimensionless (radians per M of coordinate time). Orbits are parametrized by
(p, e): semi-latus rectum and eccentricity, with Darwin anomaly chi such that
``r = p / (1 + e cos chi)``.

Design note: instead of the closed forms with complete elliptic integrals
(Cutler-Kennefick-Poisson 1994), the radial period and periapsis advance are
computed by trapezoidal quadrature of the smooth 2*pi-periodic Darwin
integrands — spectrally accurate, branch-free, and vmappable (a
fixed-size reduction instead of iterative AGM loops).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Quadrature resolution for the periodic Darwin integrands. 256 nodes keeps
# spectral accuracy down to p - p_sep ~ 0.05 (integrand peak width
# ~ sqrt((p - 6 - 2e)/e) in chi); the trajectory stops at p_sep + ~0.1.
_N_CHI = 256


def separatrix(e: jax.Array) -> jax.Array:
    """Schwarzschild separatrix p_s(e) = 6 + 2e (unstable-orbit boundary)."""
    return 6.0 + 2.0 * e


def energy_angmom(p: jax.Array, e: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Specific orbital energy E and angular momentum L of the geodesic.

    E^2 = ((p-2)^2 - 4 e^2) / (p (p - 3 - e^2)),  L^2 = p^2 / (p - 3 - e^2).
    """
    denom = p - 3.0 - e * e
    energy = jnp.sqrt(((p - 2.0 - 2.0 * e) * (p - 2.0 + 2.0 * e)) / (p * denom))
    angmom = p / jnp.sqrt(denom)
    return energy, angmom


@partial(jnp.vectorize, signature="(),()->(),()")
def fundamental_frequencies(p: jax.Array, e: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Dimensionless (Omega_phi, Omega_r) for a bound eccentric orbit.

    Darwin-parametrization integrands (Cutler-Kennefick-Poisson 1994):
      dphi/dchi = sqrt(p / (p - 6 - 2 e cos chi))
      dt/dchi   = p^2 sqrt((p-2)^2 - 4e^2)
                  / ((p - 2 - 2 e cos chi) (1 + e cos chi)^2
                     sqrt(p - 6 - 2 e cos chi))
    T_r = int_0^{2pi} dt/dchi, Dphi = int_0^{2pi} dphi/dchi;
    Omega_r = 2 pi / T_r, Omega_phi = Dphi / T_r.

    The circular limit e -> 0 is handled by the same quadrature (integrands
    become constant): Omega_phi -> p^{-3/2}... (exactly 1/(p^{3/2}) * ...),
    matching the closed forms.
    """
    chi = (2.0 * jnp.pi / _N_CHI) * jnp.arange(_N_CHI)
    ecos = e * jnp.cos(chi)
    rad = p - 6.0 - 2.0 * ecos  # > 0 for p above separatrix
    dphi_dchi = jnp.sqrt(p / rad)
    dt_dchi = (
        p
        * p
        * jnp.sqrt((p - 2.0) ** 2 - 4.0 * e * e)
        / ((p - 2.0 - 2.0 * ecos) * (1.0 + ecos) ** 2 * jnp.sqrt(rad))
    )
    # periodic trapezoid == mean * period
    h = 2.0 * jnp.pi / _N_CHI
    t_r = jnp.sum(dt_dchi) * h
    dphi = jnp.sum(dphi_dchi) * h
    omega_r = 2.0 * jnp.pi / t_r
    omega_phi = dphi / t_r
    return omega_phi, omega_r


def fundamental_frequencies_seconds(
    p: jax.Array, e: jax.Array, mass_sun: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """(Omega_phi, Omega_r) in rad/s for a central mass in solar masses."""
    from ..utils.constants import MTSUN_SI

    omega_phi, omega_r = fundamental_frequencies(p, e)
    scale = 1.0 / (mass_sun * MTSUN_SI)
    return omega_phi * scale, omega_r * scale


_ANTIDERIV_CACHE: dict[int, "object"] = {}


def _antiderivative_matrix(n: int):
    """Real (n, n) matrix A with (A g)_i = antiderivative of zero-mean
    periodic g at chi_i, vanishing at chi_0 = 0. Built host-side via numpy
    FFT of the identity; cached per resolution."""
    if n not in _ANTIDERIV_CACHE:
        import numpy as np

        eye = np.eye(n)
        gk = np.fft.rfft(eye, axis=0)  # spectrum of each basis vector
        k = np.arange(gk.shape[0])
        scale = np.zeros_like(k, dtype=np.complex128)
        scale[1:] = 1.0 / (1j * k[1:])
        gint = np.fft.irfft(gk * scale[:, None], n=n, axis=0)
        gint = gint - gint[0:1, :]
        _ANTIDERIV_CACHE[n] = gint
    return _ANTIDERIV_CACHE[n]


def darwin_orbit(p: jax.Array, e: jax.Array, n_chi: int = _N_CHI):
    """One radial period of the bound geodesic, sampled uniformly in chi.

    Returns dict with chi, r, t (coordinate time from periapsis, t(0)=0),
    phi (azimuth from periapsis, phi(0)=0), and the period/advance (T_r,
    Dphi). Used by the amplitude module to Fourier-decompose source
    multipoles over the orbital torus.

    Integrals of the periodic integrands are done spectrally: cumulative
    t(chi) and phi(chi) via a precomputed real spectral-antiderivative matrix
    (the operator is linear, so it is baked host-side with numpy FFTs into a
    dense (n, n) f64 matmul — complex dtypes never reach the device).
    """
    chi = (2.0 * jnp.pi / n_chi) * jnp.arange(n_chi)
    ecos = e * jnp.cos(chi)
    rad = p - 6.0 - 2.0 * ecos
    r = p / (1.0 + ecos)
    dphi_dchi = jnp.sqrt(p / rad)
    dt_dchi = (
        p
        * p
        * jnp.sqrt((p - 2.0) ** 2 - 4.0 * e * e)
        / ((p - 2.0 - 2.0 * ecos) * (1.0 + ecos) ** 2 * jnp.sqrt(rad))
    )

    a_op = jnp.asarray(_antiderivative_matrix(n_chi))

    def periodic_antiderivative(g):
        """Antiderivative of periodic g(chi) with zero value at chi=0."""
        mean = jnp.mean(g)
        gint = a_op @ (g - mean)
        return gint + mean * chi

    t = periodic_antiderivative(dt_dchi)
    phi = periodic_antiderivative(dphi_dchi)
    h = 2.0 * jnp.pi / n_chi
    t_r = jnp.sum(dt_dchi) * h
    dphi_total = jnp.sum(dphi_dchi) * h
    return {"chi": chi, "r": r, "t": t, "phi": phi, "T_r": t_r, "Dphi": dphi_total}


# ---------------------------------------------------------------------------
# Kerr equatorial (a != 0, x = +-1) extension
#
# Pins the generic-spin signature of the reference engine's
# ``get_fundamental_frequencies(a, p, e, x)`` / ``get_separatrix(a, e, x)``
# (reference FD notebook cell 1) for EQUATORIAL orbits. Same design as
# the Schwarzschild path: a fixed-count Newton solve (vmappable, branch-free)
# for the orbit constants and spectral Darwin quadrature for the
# frequencies — no elliptic-integral AGM loops.
#
# Radial potential (equatorial, Carter constant Q = 0; Boyer-Lindquist,
# geometric units M = 1):
#   R(r) = [E(r^2+a^2) - aL]^2 - Delta [r^2 + (L-aE)^2],
#   R(r)/r = c3 r^3 + c2 r^2 + c1 r + c0,
#   c3 = E^2-1, c2 = 2, c1 = -[L^2 + a^2(1-E^2)], c0 = 2 (L-aE)^2.
# Bound-orbit conditions S(r_p) = S(r_a) = 0 are solved in the
# DIVIDED-DIFFERENCE form {S(r_p) = 0, [S(r_a)-S(r_p)]/(r_a-r_p) = 0} which
# stays perfectly conditioned in the circular limit (second equation ->
# S'(r) = 0). The third root r3 = 2(L-aE)^2 / ((1-E^2) r_p r_a) (Vieta)
# regularizes the quadrature:
#   dlambda/dchi = g(chi) = sqrt(1-e^2) /
#                  [sqrt(1-E^2) (1+e cos chi) sqrt(r (r - r3))]
#   dt/dchi   = P_t(r) g,   P_t = a(L-aE) + (r^2+a^2) T / Delta,
#   dphi/dchi = P_phi(r) g, P_phi = (L-aE) + a T / Delta,  T = E(r^2+a^2)-La
# and the polar frequency of the equatorial orbit comes from the Mino-time
# polar potential with Q -> 0: Upsilon_theta = sqrt(L^2 + a^2(1-E^2)), so
# Omega_theta = Upsilon_theta Lambda_r / T_r. All three reduce exactly to
# the Schwarzschild results at a = 0 (Omega_theta -> Omega_phi since
# dphi/dlambda = L there).
# ---------------------------------------------------------------------------

_N_EL_NEWTON = 40


@partial(jnp.vectorize, signature="(),(),()->(),()")
def kerr_eq_energy_angmom(a, p, e):
    """(E, L) of the bound equatorial Kerr orbit (L signed; retrograde via
    a < 0 or a retrograde Schwarzschild-style guess is NOT needed — pass
    x = -1 through `fundamental_frequencies_kerr`, which maps to -a)."""
    r_p = p / (1.0 + e)
    r_a = p / (1.0 - e + 1e-300)  # e < 1 for bound orbits

    # Schwarzschild starting point (exact at a = 0)
    denom = jnp.maximum(p - 3.0 - e * e, 1e-12)
    e0 = jnp.sqrt(
        jnp.maximum((p - 2.0 - 2.0 * e) * (p - 2.0 + 2.0 * e), 1e-300) / (p * denom)
    )
    l0 = p / jnp.sqrt(denom)

    sum_sq = r_a * r_a + r_a * r_p + r_p * r_p
    sum_r = r_a + r_p

    def newton(carry, _):
        en, lz = carry
        x = lz - a * en
        c3 = en * en - 1.0
        c1 = -(lz * lz + a * a * (1.0 - en * en))
        c0 = 2.0 * x * x
        f1 = c3 * r_p**3 + 2.0 * r_p**2 + c1 * r_p + c0
        f2 = c3 * sum_sq + 2.0 * sum_r + c1
        # analytic Jacobian
        d_c3_e = 2.0 * en
        d_c1_e = 2.0 * a * a * en
        d_c0_e = -4.0 * a * x
        d_c1_l = -2.0 * lz
        d_c0_l = 4.0 * x
        j11 = d_c3_e * r_p**3 + d_c1_e * r_p + d_c0_e
        j12 = d_c1_l * r_p + d_c0_l
        j21 = d_c3_e * sum_sq + d_c1_e
        j22 = d_c1_l
        det = j11 * j22 - j12 * j21
        det = jnp.where(jnp.abs(det) > 1e-300, det, 1e-300)
        en = en - (f1 * j22 - f2 * j12) / det
        lz = lz - (j11 * f2 - j21 * f1) / det
        return (en, lz), None

    (energy, angmom), _ = jax.lax.scan(newton, (e0, l0), None, length=_N_EL_NEWTON)
    return energy, angmom


@partial(jnp.vectorize, signature="(),(),()->(),(),()")
def _kerr_eq_freqs_prograde(a, p, e):
    """(Omega_phi, Omega_theta, Omega_r) for the equatorial orbit; spin a
    signed (negative a = retrograde), orbital angular momentum positive."""
    energy, angmom = kerr_eq_energy_angmom(a, p, e)
    r_p = p / (1.0 + e)
    r_a = p / (1.0 - e + 1e-300)
    x = angmom - a * energy
    one_m_e2 = jnp.maximum(1.0 - energy * energy, 1e-300)
    r3 = 2.0 * x * x / (one_m_e2 * r_p * r_a)

    chi = (2.0 * jnp.pi / _N_CHI) * jnp.arange(_N_CHI)
    ecos = e * jnp.cos(chi)
    r = p / (1.0 + ecos)
    delta = r * r - 2.0 * r + a * a
    big_t = energy * (r * r + a * a) - angmom * a
    g = jnp.sqrt(jnp.maximum(1.0 - e * e, 0.0)) / (
        jnp.sqrt(one_m_e2)
        * (1.0 + ecos)
        * jnp.sqrt(jnp.maximum(r * (r - r3), 1e-300))
    )
    p_t = a * x + (r * r + a * a) * big_t / delta
    p_phi = x + a * big_t / delta

    h = 2.0 * jnp.pi / _N_CHI
    t_r = jnp.sum(p_t * g) * h
    dphi = jnp.sum(p_phi * g) * h
    lam_r = jnp.sum(g) * h

    omega_r = 2.0 * jnp.pi / t_r
    omega_phi = dphi / t_r
    ups_theta = jnp.sqrt(angmom * angmom + a * a * one_m_e2)
    omega_theta = ups_theta * lam_r / t_r
    return omega_phi, omega_theta, omega_r


def fundamental_frequencies_kerr(a, p, e, x=1.0):
    """(Omega_phi, Omega_theta, Omega_r) for equatorial Kerr (x = +-1).

    ``x = cos(iota)``: +1 prograde, -1 retrograde. Retrograde orbits map to
    prograde orbits in spin -a with phi -> -phi, so Omega_phi flips sign
    (signed convention); Omega_theta and Omega_r are positive. At a = 0
    reduces to the Schwarzschild results with Omega_theta = Omega_phi.
    """
    a = jnp.asarray(a, jnp.float64)
    x = jnp.asarray(x, jnp.float64)
    a_eff = jnp.where(x >= 0, a, -a)
    om_phi, om_th, om_r = _kerr_eq_freqs_prograde(a_eff, jnp.asarray(p), jnp.asarray(e))
    return jnp.where(x >= 0, om_phi, -om_phi), om_th, om_r


@partial(jnp.vectorize, signature="(),()->()")
def _separatrix_prograde(a, e):
    """Equatorial separatrix p_s(a, e) by bisection on the stability margin
    r_p - r3 (the bound orbit exists while the periapsis stays outside the
    third root of the radial potential; they merge at the separatrix)."""

    def margin(p):
        energy, angmom = kerr_eq_energy_angmom(a, p, e)
        r_p = p / (1.0 + e)
        r_a = p / (1.0 - e + 1e-300)
        x = angmom - a * energy
        one_m_e2 = 1.0 - energy * energy
        r3 = 2.0 * x * x / (one_m_e2 * r_p * r_a)
        m = jnp.where(
            jnp.isfinite(energy) & (one_m_e2 > 0.0) & (energy > 0.0),
            r_p - r3,
            -1.0,
        )
        return m

    lo = jnp.asarray(1.0 + 1e-3)
    hi = jnp.asarray(12.0 + 2.0 * e)

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        stable = margin(mid) > 0.0
        return jnp.where(stable, lo, mid), jnp.where(stable, mid, hi)

    lo, hi = jax.lax.fori_loop(0, 64, body, (lo, hi))
    return 0.5 * (lo + hi)


def separatrix_kerr(a, e, x=1.0):
    """p_s(a, e, x) for equatorial orbits; a = 0 gives 6 + 2e exactly."""
    a = jnp.asarray(a, jnp.float64)
    x = jnp.asarray(x, jnp.float64)
    a_eff = jnp.where(x >= 0, a, -a)
    return _separatrix_prograde(a_eff, jnp.asarray(e))


# ---------------------------------------------------------------------------
# Generic-inclination bound Kerr geodesics (round 4; retires the last
# few.utils.utility signature gap — reference FD notebook cell 1 pins
# get_fundamental_frequencies(a, p, e, x) for generic x = cos I).
#
# Conventions (Schmidt 2002 / Drasco-Hughes 2004 structure, computed here
# by spectral quadrature instead of elliptic integrals — fixed-shape
# sums, same pattern as the equatorial path above):
#   x = cos I with z_- = cos^2(theta_min) = 1 - x^2 and sign(L_z) =
#   sign(x) (the few convention);
#   radial potential R(r) = (E(r^2+a^2) - a L_z)^2
#                           - Delta (r^2 + (L_z - a E)^2 + Q)
#     = (1-E^2)(r_a - r)(r - r_p)(r - r3)(r - r4);
#   polar potential in z = cos^2(theta):
#     Theta(z) (1 - z) = beta (z_- - z)(z_+ - z),  beta = a^2 (1 - E^2),
#     with the exact identity beta z_+ = beta + L_z^2/(1 - z_-);
#   Mino-time rates split into r- and theta-parts:
#     dt/dlam  = T_r(r) + a^2 E z,
#       T_r = (r^2+a^2)/Delta (E(r^2+a^2) - a L_z) + a L_z - a^2 E,
#     dphi/dlam = Phi_r(r) + L_z/(1-z),
#       Phi_r = a/Delta (E(r^2+a^2) - a L_z) - a E,
#   so Gamma = <T_r>_r + a^2 E <z>_th, Ups_phi = <Phi_r>_r + L_z
#   <1/(1-z)>_th, Ups_r = 2 pi / Lam_r, Ups_th = 2 pi / Lam_th, and the
#   coordinate-time frequencies are Omega_i = Ups_i / Gamma.
# Quadratures: the Darwin substitution r = p/(1+e cos chi) makes
# dr/sqrt(R) a smooth even 2pi-periodic integrand (endpoint-weighted
# trapezoid on [0, pi] is spectrally accurate); the polar substitution
# z = z_- sin^2 psi likewise gives dpsi / sqrt(beta z_+ - beta z_-
# sin^2 psi) on [0, pi/2].
# ---------------------------------------------------------------------------


def _kerr_gen_EL(a, p, e, x, n_newton: int = _N_EL_NEWTON):
    """(E, L_z, Q) of the generic bound orbit (scalar core).

    Newton in (E, L_z) on the well-conditioned residual pair
    {(R(r_p) + R(r_a))/2, (R(r_a) - R(r_p))/(r_a - r_p)} (the divided
    difference keeps the system regular as e -> 0), with Q eliminated by
    the polar-turning-point constraint Q = z_- (beta + L_z^2/(1 - z_-)).
    Seeded from the Schwarzschild (E, L) with L_z = x L, exact at a = 0.
    """
    r_p = p / (1.0 + e)
    r_a = p / (1.0 - e + 1e-300)
    z_minus = jnp.clip(1.0 - x * x, 0.0, 1.0)
    one_m_zm = jnp.maximum(1.0 - z_minus, 1e-300)  # = x^2

    def q_of(en, lz):
        beta = a * a * (1.0 - en * en)
        return z_minus * (beta + lz * lz / one_m_zm)

    def big_r(r, en, lz, q):
        delta = r * r - 2.0 * r + a * a
        t = en * (r * r + a * a) - a * lz
        return t * t - delta * (r * r + (lz - a * en) ** 2 + q)

    def resid(el):
        en, lz = el[0], el[1]
        q = q_of(en, lz)
        f_p = big_r(r_p, en, lz, q)
        f_a = big_r(r_a, en, lz, q)
        return jnp.stack(
            [0.5 * (f_p + f_a), (f_a - f_p) / jnp.maximum(r_a - r_p, 1e-12)]
        )

    # Schwarzschild seed (exact at a = 0)
    denom = jnp.maximum(p - 3.0 - e * e, 1e-12)
    e0 = jnp.sqrt(
        jnp.maximum((p - 2.0) ** 2 - 4.0 * e * e, 1e-300) / (p * denom)
    )
    l0 = p / jnp.sqrt(denom)

    def newton(carry, _):
        el = carry
        f = resid(el)
        jac = jax.jacfwd(resid)(el)
        det = jac[0, 0] * jac[1, 1] - jac[0, 1] * jac[1, 0]
        det = jnp.where(jnp.abs(det) > 1e-300, det, 1e-300)
        d0 = (f[0] * jac[1, 1] - f[1] * jac[0, 1]) / det
        d1 = (jac[0, 0] * f[1] - jac[1, 0] * f[0]) / det
        return el - jnp.stack([d0, d1]), None

    el0 = jnp.stack([e0, x * l0])
    el, _ = jax.lax.scan(newton, el0, None, length=n_newton)
    en, lz = el[0], el[1]
    return en, lz, q_of(en, lz)


@partial(jnp.vectorize, signature="(),(),(),()->(),(),()")
def kerr_gen_constants(a, p, e, x):
    """(E, L_z, Q) for generic (a, p, e, x = cos I); vectorized."""
    return _kerr_gen_EL(a, p, e, x)


@partial(jnp.vectorize, signature="(),(),(),()->(),(),()")
def _kerr_gen_freqs(a, p, e, x):
    en, lz, q = _kerr_gen_EL(a, p, e, x)
    r_p = p / (1.0 + e)
    r_a = p / (1.0 - e + 1e-300)
    one_m_e2 = jnp.maximum(1.0 - en * en, 1e-300)
    beta = a * a * one_m_e2
    z_minus = jnp.clip(1.0 - x * x, 0.0, 1.0)
    one_m_zm = jnp.maximum(1.0 - z_minus, 1e-300)

    # remaining radial roots by Vieta (r3 >= r4)
    s34 = 2.0 / one_m_e2 - (r_a + r_p)
    p34 = a * a * q / (one_m_e2 * r_a * r_p)
    disc = jnp.sqrt(jnp.maximum(s34 * s34 - 4.0 * p34, 0.0))
    r3 = 0.5 * (s34 + disc)
    r4 = jnp.where(r3 > 1e-300, p34 / jnp.maximum(r3, 1e-300), 0.0)

    # ---- radial averages (Darwin angle, endpoint-weighted trapezoid) ----
    n_r = _N_CHI // 2 + 1
    chi = jnp.linspace(0.0, jnp.pi, n_r)
    wts = jnp.ones(n_r).at[0].set(0.5).at[-1].set(0.5) * (jnp.pi / (n_r - 1))
    r = p / (1.0 + e * jnp.cos(chi))
    g = jnp.sqrt(jnp.maximum(1.0 - e * e, 1e-300)) / (
        (1.0 + e * jnp.cos(chi))
        * jnp.sqrt(one_m_e2)
        * jnp.sqrt(jnp.maximum((r - r3) * (r - r4), 1e-300))
    )
    delta = r * r - 2.0 * r + a * a
    big_t = en * (r * r + a * a) - a * lz
    t_r = (r * r + a * a) / delta * big_t + a * lz - a * a * en
    phi_r = a / delta * big_t - a * en
    lam_r_half = jnp.sum(wts * g)  # = Lambda_r / 2
    avg_t_r = jnp.sum(wts * g * t_r) / lam_r_half
    avg_phi_r = jnp.sum(wts * g * phi_r) / lam_r_half

    # ---- polar averages (z = z_- sin^2 psi) ----
    # the <1/(1-z)> integrand peaks as 1/x^2 at psi = pi/2, so 257 nodes
    # hold spectral accuracy down to |x| ~ 0.1 (near-polar orbits below
    # that need a denser rule; tested domain |x| >= 0.1)
    n_th = 257
    psi = jnp.linspace(0.0, 0.5 * jnp.pi, n_th)
    wth = (
        jnp.ones(n_th).at[0].set(0.5).at[-1].set(0.5)
        * (0.5 * jnp.pi / (n_th - 1))
    )
    beta_zp = beta + lz * lz / one_m_zm  # exact identity, stable at x -> +-1
    z = z_minus * jnp.sin(psi) ** 2
    w_pol = jnp.sqrt(jnp.maximum(beta_zp - beta * z, 1e-300))
    i0 = jnp.sum(wth / w_pol)  # = Lambda_th / 4
    avg_z = jnp.sum(wth * z / w_pol) / i0
    # L_z <1/(1-z)>: 1 - z >= x^2 > 0 on the orbit; identically 0 for
    # polar orbits (L_z = 0 at x = 0, where 1 - z touches 0)
    one_mz = jnp.maximum(1.0 - z, 1e-300)
    avg_lz_1mz = jnp.where(
        z_minus < 1.0 - 1e-14,
        lz * jnp.sum(wth / (one_mz * w_pol)) / i0,
        0.0,
    )

    gamma = avg_t_r + a * a * en * avg_z
    ups_phi = avg_phi_r + avg_lz_1mz
    omega_r = (jnp.pi / lam_r_half) / gamma
    omega_theta = (0.5 * jnp.pi / i0) / gamma
    omega_phi = ups_phi / gamma
    return omega_phi, omega_theta, omega_r


def fundamental_frequencies_kerr_generic(a, p, e, x):
    """(Omega_phi, Omega_theta, Omega_r), generic bound Kerr geodesic.

    ``x = cos I`` with I the orbital inclination (few convention:
    z_- = 1 - x^2, sign(L_z) = sign(x)); Omega_phi is signed by the
    azimuthal sense, Omega_theta/Omega_r positive. Reduces to the
    equatorial path at |x| = 1 (tested) and to Schwarzschild at a = 0
    where Ups_phi = sign(x) Ups_theta exactly.
    """
    return _kerr_gen_freqs(
        jnp.asarray(a, jnp.float64), jnp.asarray(p, jnp.float64),
        jnp.asarray(e, jnp.float64), jnp.asarray(x, jnp.float64),
    )


@partial(jnp.vectorize, signature="(),(),()->()")
def _separatrix_generic(a, e, x):
    """p_s(a, e, x) by bisection on the periapsis/third-root margin."""

    def margin(p):
        en, lz, q = _kerr_gen_EL(a, p, e, x)
        r_p = p / (1.0 + e)
        r_a = p / (1.0 - e + 1e-300)
        one_m_e2 = 1.0 - en * en
        s34 = 2.0 / jnp.maximum(one_m_e2, 1e-300) - (r_a + r_p)
        p34 = a * a * q / (jnp.maximum(one_m_e2, 1e-300) * r_a * r_p)
        disc = jnp.sqrt(jnp.maximum(s34 * s34 - 4.0 * p34, 0.0))
        r3 = 0.5 * (s34 + disc)
        ok = jnp.isfinite(en) & (one_m_e2 > 0.0) & (en > 0.0)
        return jnp.where(ok, r_p - r3, -1.0)

    lo = jnp.asarray(1.0 + 1e-3)
    hi = jnp.asarray(12.0 + 2.0 * e)

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        stable = margin(mid) > 0.0
        return jnp.where(stable, lo, mid), jnp.where(stable, mid, hi)

    lo, hi = jax.lax.fori_loop(0, 64, body, (lo, hi))
    return 0.5 * (lo + hi)


def separatrix_kerr_generic(a, e, x):
    """Generic-inclination separatrix p_s(a, e, x)."""
    return _separatrix_generic(
        jnp.asarray(a, jnp.float64), jnp.asarray(e, jnp.float64),
        jnp.asarray(x, jnp.float64),
    )


__all__ = [
    "separatrix",
    "energy_angmom",
    "fundamental_frequencies",
    "fundamental_frequencies_seconds",
    "darwin_orbit",
    "kerr_eq_energy_angmom",
    "fundamental_frequencies_kerr",
    "separatrix_kerr",
    "kerr_gen_constants",
    "fundamental_frequencies_kerr_generic",
    "separatrix_kerr_generic",
]
