"""Eccentric-orbit point-particle amplitudes from the RWZ solver.

Extends tools/rwz/circular.py to bound eccentric Schwarzschild geodesics:
per (l, m, n) the asymptotic master-function amplitude

    C_lmn = (1 / (W T_r)) int_0^{T_r} dt  e^{i omega_mn t - i m phi(t)}
            * sum_k  qhat_k(t) G_k(r(t)),     omega_mn = m Om_phi + n Om_r,

the standard frequency-domain variation-of-parameters projection of the
delta-function source supported on the orbit (the Darwin-parametrized
integrand is smooth and 2 pi periodic in chi, so uniform-chi trapezoid
quadrature is spectrally accurate).  G_k are the radial kernels

    order 0:  G_k =  X_in(r) c_k(r) / f(r)
    order 1:  G_k = -d/dr [ X_in(r) c_k(r) / f(r) ]

with c_k the master-equation source coefficients DERIVED from the
linearized Einstein equations (derive_odd.py / generated_even.py — no
transcribed literature formulas), and qhat_k the instantaneous harmonic
projections of the point-particle stress tensor (phase e^{-i m phi}
factored out; harmonics evaluated at the equator via the cached sympy
Gram machinery in circular.py).  Eccentric orbits populate the radial
channels the circular case lacks: Sr (odd T_rB), Qtr / Qrr / Qrv (even).

Per-mode flux normalization matches tools/rwz/calibrate.py:

    F_lmn = N_l |omega C / 2|^2   (even parity, l + m even)
    F_lmn = N_l |C|^2             (odd parity,  l + m odd)
    N_l = (l+2)! / ((l-2)! 8 pi)

For Schwarzschild these RWZ fluxes carry the identical physical content
to the reference's Teukolsky per-mode data (reference emri_pe.py:55-57,
620: RomanAmplitude + SchwarzEccFlux data files, not redistributable) —
this module computes it from first principles instead.

Validation (tests/test_rwz_eccentric.py): circular limit against
circular.py, Newtonian limit per (l, m, n) against the package's
validated flat-space multipole mode power, quadrature-resolution
convergence.  Host-side tooling (numpy/scipy); generates calibration
data for the JAX amplitude backends, never on the jit path.
"""

from __future__ import annotations

import functools
from math import factorial, pi

import numpy as np

from .circular import even_angular, odd_angular
from .solver import homogeneous_rw, homogeneous_zerilli

# ---------------------------------------------------------------------------
# geodesic (bound eccentric, M = 1) — same Darwin conventions as
# emri_frequencydomainwaveforms_tpu/models/geodesic.py
# ---------------------------------------------------------------------------


def darwin_orbit(p: float, e: float, n_chi: int = 256) -> dict:
    """One radial period sampled uniformly in chi (numpy host version).

    Returns chi, r, t, phi (t = phi = 0 at periapsis), u_r (lowered radial
    4-velocity), specific E / L, T_r, Dphi, and the fundamental
    frequencies (Om_phi, Om_r).  t/phi come from the FFT antiderivative
    of the smooth periodic integrands (spectrally accurate).
    """
    if not 0.0 < e < 1.0:
        raise ValueError("need 0 < e < 1 (use circular.py for e = 0)")
    if p <= 6.0 + 2.0 * e:
        raise ValueError("orbit inside the separatrix")
    chi = (2.0 * np.pi / n_chi) * np.arange(n_chi)
    ecos = e * np.cos(chi)
    rad = p - 6.0 - 2.0 * ecos
    r = p / (1.0 + ecos)

    denom = p - 3.0 - e * e
    energy = np.sqrt(((p - 2.0) ** 2 - 4.0 * e * e) / (p * denom))
    angmom = p / np.sqrt(denom)

    dphi_dchi = np.sqrt(p / rad)
    dt_dchi = (
        p * p * np.sqrt((p - 2.0) ** 2 - 4.0 * e * e)
        / ((p - 2.0 - 2.0 * ecos) * (1.0 + ecos) ** 2 * np.sqrt(rad))
    )

    def antiderivative(g):
        mean = g.mean()
        gk = np.fft.rfft(g - mean)
        k = np.arange(gk.shape[0])
        gk[1:] /= 1j * k[1:]
        gk[0] = 0.0
        gi = np.fft.irfft(gk, n=n_chi)
        return (gi - gi[0]) + mean * chi

    t = antiderivative(dt_dchi)
    phi = antiderivative(dphi_dchi)
    h = 2.0 * np.pi / n_chi
    t_r = dt_dchi.sum() * h
    dphi_total = dphi_dchi.sum() * h

    # u^r = (dr/dchi) (dchi/dt) (dt/dtau);  u^t = E / f
    f = 1.0 - 2.0 / r
    dr_dchi = p * e * np.sin(chi) / (1.0 + ecos) ** 2
    u_up_r = dr_dchi / dt_dchi * (energy / f)
    u_r = u_up_r / f  # lowered index

    return {
        "chi": chi, "r": r, "t": t, "phi": phi, "u_r": u_r,
        "E": energy, "L": angmom, "T_r": t_r, "Dphi": dphi_total,
        "Om_phi": dphi_total / t_r, "Om_r": 2.0 * np.pi / t_r,
        "u_t_up": energy / f,  # u^t along the orbit
        "dt_dchi": dt_dchi,
    }


# ---------------------------------------------------------------------------
# master-equation source coefficients (symbolically derived, cached)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _odd_master_fns():
    """Lambdified odd-parity c_k(r)/f and d(c_k/f)/dr per channel key,
    from derive_odd.derive() (run once, ~8 s of sympy; M = 1).

    Returns {(channel, order): (cf, dcf)} with channel in {"Sr", "Ss"}.
    """
    import sympy as sp

    from .derive_odd import derive

    res = derive()
    rsym = sp.Symbol("r", positive=True)
    M = sp.Symbol("M", positive=True)
    f = 1 - 2 / rsym
    out = {}
    for key, name in (
        (("Sr", 0), "src_Sr"),
        (("Ss", 0), "src_Ss"),
        (("Sr", 1), "src_dSr"),
        (("Ss", 1), "src_dSs"),
    ):
        c = res[name]
        c = sp.sympify(c).subs(M, 1).subs(sp.Symbol("r"), rsym)
        if c == 0:
            continue
        cf = sp.cancel(sp.together(c / f))
        out[key] = (
            sp.lambdify(rsym, cf, "numpy"),
            sp.lambdify(rsym, sp.diff(cf, rsym), "numpy"),
        )
    return out


@functools.lru_cache(maxsize=None)
def _even_master_fns(l: int):
    """Even-parity {(Qname, order): (cf(r, w), dcf(r, w))} including 1/f
    (identical construction to circular._even_master_fns)."""
    import sympy as sp

    from . import generated_even as gen

    lam_val = sp.Rational((l - 1) * (l + 2), 2)
    rsym, wsym, lsym = sp.Symbol("r"), sp.Symbol("omega"), sp.Symbol("lam")
    out = {}
    for key, srep in gen.S_EVEN.items():
        c = sp.sympify(srep).subs(lsym, lam_val)
        cf = sp.cancel(sp.together(c / (1 - 2 / rsym)))
        out[key] = (
            sp.lambdify((rsym, wsym), cf, "numpy"),
            sp.lambdify((rsym, wsym), sp.diff(cf, rsym), "numpy"),
        )
    return out


# ---------------------------------------------------------------------------
# eccentric amplitudes
# ---------------------------------------------------------------------------


def _orbit_kernels(l: int, parity: str, omega: float, r_half: np.ndarray):
    """X_in and dX_in/dr on the ascending half-orbit radius grid, plus the
    Wronskian.  r_half must be strictly increasing (chi in [0, pi])."""
    hom = homogeneous_rw(l) if parity == "odd" else homogeneous_zerilli(l)
    X_in, dX_in_rs, _, _, W, Werr = hom.wronskian_and_fields(omega, r_half)
    if Werr > 1e-7:
        raise RuntimeError(f"Wronskian drift {Werr} at l={l} omega={omega}")
    f = 1.0 - 2.0 / r_half
    return X_in, dX_in_rs / f, W


def _mirror(arr_half: np.ndarray, n_chi: int) -> np.ndarray:
    """Extend a half-orbit (chi in [0, pi], K+1 points) sample to the full
    uniform chi grid (n_chi points) using r(2 pi - chi) = r(chi)."""
    k = n_chi // 2
    out = np.empty(n_chi, dtype=arr_half.dtype)
    out[: k + 1] = arr_half
    out[k + 1 :] = arr_half[1:k][::-1]
    return out


def eccentric_amplitude(
    l: int, m: int, n: int, p: float, e: float, n_chi: int = 256,
    _orbit: dict | None = None, return_coarse: bool = False,
) -> tuple[complex, float] | tuple[complex, float, complex]:
    """C_lmn (asymptotic master amplitude, mu = M = 1) and omega_mn.

    m may be any sign; the equatorial source obeys C_{l,-m,-n} =
    +/- (-1)^l conj(C_{l,m,n}) (+ even parity, - odd), so callers
    usually keep m >= 1 (identical per-mode flux).

    ``return_coarse=True`` additionally returns the SAME integral evaluated
    on the embedded half-resolution chi grid (every other node of the
    uniform grid; the homogeneous solve is shared, so this is nearly free).
    |C - C_coarse| is a conservative quadrature-error estimate for C (it
    approximates the HALF-grid's error; the fine grid's own error is
    smaller still for this spectrally-convergent trapezoid) — the per-node
    error bars stored by tools/rwz/calibrate_ecc.py.
    """
    orb = _orbit if _orbit is not None else darwin_orbit(p, e, n_chi)
    n_chi = len(orb["chi"])
    if n_chi % 2:
        raise ValueError("n_chi must be even")
    omega = m * orb["Om_phi"] + n * orb["Om_r"]
    if omega == 0.0:
        return 0.0 + 0.0j, 0.0

    k = n_chi // 2
    r_half = orb["r"][: k + 1]  # strictly increasing for e > 0
    parity = "odd" if (l + m) % 2 else "even"
    X_half, dX_half, W = _orbit_kernels(l, parity, omega, r_half)
    X = _mirror(X_half, n_chi)
    dX = _mirror(dX_half, n_chi)

    r = orb["r"]
    u_r = orb["u_r"]
    E, L = orb["E"], orb["L"]
    pref = 1.0 / (orb["u_t_up"] * r * r)  # mu / (u^t r^2), mu = 1

    if parity == "odd":
        ang = odd_angular(l, m)
        fns = _odd_master_fns()
        q = {
            "Sr": pref * u_r * L * np.conj(ang["xi_ph_eq"]) / ang["N_xi"],
            "Ss": pref * L * L * np.conj(ang["S_phph_eq"]) / ang["N_S"],
        }
        total = np.zeros(n_chi, dtype=complex)
        for (name, order), (cf, dcf) in fns.items():
            cfr = cf(r) * np.ones_like(r)
            if order == 0:
                total += q[name] * X * cfr
            else:
                total += -q[name] * (dX * cfr + X * dcf(r) * np.ones_like(r))
    else:
        ang = even_angular(l, m)
        lam_full = l * (l + 1)
        q = {
            "Qtt": pref * E * E * np.conj(ang["Y_eq"]),
            "Qtr": pref * (-E) * u_r * np.conj(ang["Y_eq"]),
            "Qrr": pref * u_r * u_r * np.conj(ang["Y_eq"]),
            "Qtv": pref * (-E) * L * np.conj(ang["dphY_eq"]) / lam_full,
            "Qrv": pref * u_r * L * np.conj(ang["dphY_eq"]) / lam_full,
            "Qu": 0.5 * pref * L * L * np.conj(ang["Y_eq"]),
            "Qz": pref * L * L * np.conj(ang["Z_phph_eq"]) / ang["N_Z"],
        }
        fns = _even_master_fns(l)
        total = np.zeros(n_chi, dtype=complex)
        for (name, order), (cf, dcf) in fns.items():
            qv = q.get(name)
            if qv is None:
                continue
            cfr = cf(r, omega) * np.ones_like(r)
            if order == 0:
                total += qv * X * cfr
            elif order == 1:
                total += -qv * (dX * cfr + X * dcf(r, omega) * np.ones_like(r))
            else:
                raise RuntimeError("unexpected source derivative order")

    phase = np.exp(1j * (omega * orb["t"] - m * orb["phi"]))
    h = 2.0 * np.pi / n_chi
    integrand = orb["dt_dchi"] * phase * total
    integral = np.sum(integrand) * h
    c_fine = integral / (W * orb["T_r"])
    if not return_coarse:
        return c_fine, omega
    # embedded half-resolution quadrature (T_r re-derived on the coarse
    # grid too, so the estimate covers the orbit-functional error as well)
    t_r_coarse = np.sum(orb["dt_dchi"][::2]) * (2.0 * h)
    c_coarse = np.sum(integrand[::2]) * (2.0 * h) / (W * t_r_coarse)
    return c_fine, omega, c_coarse


def eccentric_flux_mode(
    l: int, m: int, n: int, p: float, e: float, n_chi: int = 256,
    _orbit: dict | None = None,
) -> tuple[float, float]:
    """Per-mode energy flux F_lmn (mu = M = 1) and omega_mn."""
    C, omega = eccentric_amplitude(l, m, n, p, e, n_chi, _orbit=_orbit)
    N = factorial(l + 2) / factorial(l - 2) / (8.0 * pi)
    if (l + m) % 2 == 0:
        return N * abs(omega * C / 2.0) ** 2, omega
    return N * abs(C) ** 2, omega


__all__ = [
    "darwin_orbit",
    "eccentric_amplitude",
    "eccentric_flux_mode",
]
