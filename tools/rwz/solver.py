"""Frequency-domain Regge-Wheeler/Zerilli solver (Schwarzschild, M = 1).

Numerical machinery for the first-principles perturbation pipeline
(tools/rwz/derive_odd.py, derive_even.py): homogeneous in/up solutions of

    d^2 X / dr*^2 + (omega^2 - V(r)) X = 0

for any rational potential V(r), via the non-oscillatory envelope
u = X exp(-/+ i omega r*), with boundary series generated by sympy
undetermined coefficients (no transcribed asymptotics), integrated with
scipy DOP853 at rtol ~ 1e-12.  Point-particle amplitudes follow from the
variation-of-parameters projection

    C_inf = (1/W) int X_in(r) S(r) dr* ,   W = Wronskian(X_in, X_up),

with the delta-function sources reduced to boundary-term evaluations.

This is host-side tooling (float64 numpy/scipy): it generates and
validates the relativistic calibration data consumed by the jitted
amplitude backends; it is not on the jit hot path.

Reference parity: computes the physical content of the reference's
Teukolsky amplitude/flux data (reference emri_pe.py:55-57,620 uses
RomanAmplitude + SchwarzEccFlux data files, not redistributable).
"""

from __future__ import annotations

import functools

import numpy as np
import sympy as sp
from scipy.integrate import solve_ivp

_R = sp.Symbol("r", positive=True)
_W = sp.Symbol("omega", positive=True)
_LAM = sp.Symbol("Lam")


def v_rw(lam):
    """Regge-Wheeler potential (DERIVED in tools/rwz/derive_odd.py and
    asserted there; lam = l(l+1), M = 1)."""
    return (1 - 2 / _R) * (lam / _R**2 - 6 / _R**3)


def rstar(r):
    return r + 2.0 * np.log(0.5 * r - 1.0)


def _poly_ode_series(polyA, polyB, polyC, nterms):
    """Power-series solution a_k of A(x) u'' + B(x) u' + C(x) u = 0 with
    a_0 = 1, for polynomial coefficient lists (ascending, complex).

    Generic Frobenius-style recurrence: the x^n coefficient of the ODE is
        sum_j [ A_j (q+2)(q+1) a_{q+2} + B_j (q+1) a_{q+1} + C_j a_q ],
    q = n - j, solved sequentially for the highest-index unknown. The
    caller guarantees that unknown's coefficient never vanishes (checked)."""
    a = np.zeros(nterms, complex)
    a[0] = 1.0
    for n in range(nterms - 1):
        # collect the coefficient of a_{n+1} and the known remainder
        lead = 0.0 + 0.0j
        rem = 0.0 + 0.0j
        for j, Aj in enumerate(polyA):
            q = n - j
            if Aj == 0:
                continue
            k = q + 2
            if 0 <= k <= n:
                rem += Aj * k * (k - 1) * a[k]
            elif k == n + 1:
                lead += Aj * k * (k - 1)
        for j, Bj in enumerate(polyB):
            q = n - j
            if Bj == 0:
                continue
            k = q + 1
            if 0 <= k <= n:
                rem += Bj * k * a[k]
            elif k == n + 1:
                lead += Bj * k
        for j, Cj in enumerate(polyC):
            q = n - j
            if Cj == 0 or not (0 <= q <= n):
                continue
            rem += Cj * a[q]
        if lead == 0:
            raise RuntimeError(f"degenerate recurrence at order {n}")
        a[n + 1] = -rem / lead
    return a


class _EnvelopeSeries:
    """Boundary series for the envelope equation

        f u'' + (f' + 2 i s omega) u' - (V/f) u = 0,  s = -1 (in), +1 (up)

    (V/f is a polynomial in 1/r for RW/Zerilli-class potentials). At the
    horizon, with x = r - 2, multiplying by (x+2)^D gives a polynomial
    ODE; at infinity, with y = 1/r, dividing by y^2 does. The polynomial
    coefficient lists are built ONCE symbolically from V (cheap: V/f is
    small), then the recurrence runs numerically per omega."""

    def __init__(self, V_expr, sign, point, nterms=14):
        r = _R
        f = 1 - 2 / r
        Vof = sp.cancel(sp.together(V_expr / f))  # rational in r
        self.sign = sign
        self.point = point
        self.nterms = nterms
        x, y = sp.symbols("x y")
        wsym = sp.Symbol("w")
        u = sp.Function("u")
        if point == "horizon":
            # f u'' + (f' + 2 i s w) u' - (V/f) u = 0 in x = r - 2;
            # clear ALL denominators (works for rational V/f, e.g. the
            # Zerilli potential with its (lam r + 3M)^2 factor)
            ux = u(x)
            fx = x / (x + 2)
            dfx = 2 / (x + 2) ** 2
            Vx = Vof.subs(r, x + 2)
            ode = (
                fx * sp.Derivative(ux, (x, 2))
                + (dfx + 2 * sp.I * sign * wsym) * sp.Derivative(ux, x)
                - Vx * ux
            )
            num = sp.numer(sp.cancel(sp.together(ode)))
            var, uu = x, ux
        else:
            # r = 1/y, d/dr = -y^2 d/dy; clear denominators likewise
            uy = u(y)
            fy = 1 - 2 * y
            up = -(y**2) * sp.Derivative(uy, y)
            upp = y**4 * sp.Derivative(uy, (y, 2)) + 2 * y**3 * sp.Derivative(uy, y)
            Vy = Vof.subs(r, 1 / y)
            ode = (fy * upp + (2 * y**2 + 2 * sp.I * sign * wsym) * up - Vy * uy) / y**2
            num = sp.numer(sp.cancel(sp.together(ode)))
            var, uu = y, uy
        num = sp.expand(num)
        A = sp.expand(num.coeff(sp.Derivative(uu, (var, 2))))
        B = sp.expand(num.coeff(sp.Derivative(uu, var)))
        C = sp.expand(num.coeff(uu))
        # normalize an overall sign/scale ambiguity away (numer may carry
        # a var-dependent prefactor; recurrence is scale-invariant)
        self._polys = []
        for expr in (A, B, C):
            p = sp.Poly(sp.expand(sp.cancel(sp.together(expr))), var)
            coeffs = list(reversed(p.all_coeffs()))
            self._polys.append([sp.lambdify(wsym, c, "numpy") for c in coeffs])

    def _coeffs(self, omega):
        pa, pb, pc = (
            [complex(cf(omega)) for cf in plist] for plist in self._polys
        )
        return _poly_ode_series(pa, pb, pc, self.nterms)

    def eval(self, r0, omega):
        """u and du/dr at r0 from the boundary series."""
        a = self._coeffs(omega)
        if self.point == "horizon":
            x = r0 - 2.0
            ks = np.arange(self.nterms)
            u = np.sum(a * x**ks)
            du = np.sum(a[1:] * ks[1:] * x ** (ks[1:] - 1))
        else:
            y = 1.0 / r0
            ks = np.arange(self.nterms)
            u = np.sum(a * y**ks)
            dudy = np.sum(a[1:] * ks[1:] * y ** (ks[1:] - 1))
            du = -(y**2) * dudy
        return u, du


class Homogeneous:
    """in/up homogeneous solutions for a rational potential V(r; lam)."""

    def __init__(self, V_expr, nterms=12):
        self.V_expr = V_expr
        self.V = sp.lambdify(_R, V_expr, "numpy")
        self._ser_in = _EnvelopeSeries(V_expr, -1, "horizon", nterms)
        self._ser_up = _EnvelopeSeries(V_expr, +1, "infinity", nterms)

    def _rhs(self, sign, omega):
        V = self.V

        def rhs(r, y):
            ur, ui, vr, vi = y  # u and w = f u'
            f = 1 - 2.0 / r
            # f(f u')' = -2 i s omega f u' + V u  =>  (f u')' in r:
            # d(w)/dr = (-2 i s omega w + V u)/f
            u = ur + 1j * ui
            w_ = vr + 1j * vi
            du = w_ / f
            dw = (-2j * sign * omega * w_ + V(r) * u) / f
            return [du.real, du.imag, dw.real, dw.imag]

        return rhs

    def solve_in(self, omega, r_grid):
        """X_in envelope u (X = u e^{-i omega r*}) on ascending r_grid."""
        r0 = 2.0 + 1e-4
        u0, du0 = self._ser_in.eval(r0, omega)
        f0 = 1 - 2.0 / r0
        y0 = [u0.real, u0.imag, (f0 * du0).real, (f0 * du0).imag]
        sol = solve_ivp(
            self._rhs(-1, omega),
            (r0, r_grid[-1]),
            y0,
            t_eval=r_grid,
            method="DOP853",
            rtol=1e-12,
            atol=1e-14,
        )
        if not sol.success:
            raise RuntimeError(sol.message)
        u = sol.y[0] + 1j * sol.y[1]
        fdu = sol.y[2] + 1j * sol.y[3]
        return u, fdu  # envelope and f*du/dr

    def solve_up(self, omega, r_grid):
        """X_up envelope u (X = u e^{+i omega r*}) on descending
        integration down to min(r_grid); returned on ascending r_grid."""
        r_far = max(60.0 / omega, r_grid[-1] * 1.5, 400.0)
        u0, du0 = self._ser_up.eval(r_far, omega)
        f0 = 1 - 2.0 / r_far
        y0 = [u0.real, u0.imag, (f0 * du0).real, (f0 * du0).imag]
        sol = solve_ivp(
            self._rhs(+1, omega),
            (r_far, r_grid[0]),
            y0,
            t_eval=r_grid[::-1],
            method="DOP853",
            rtol=1e-12,
            atol=1e-14,
        )
        if not sol.success:
            raise RuntimeError(sol.message)
        u = (sol.y[0] + 1j * sol.y[1])[::-1]
        fdu = (sol.y[2] + 1j * sol.y[3])[::-1]
        return u, fdu

    def wronskian_and_fields(self, omega, r_eval):
        """X_in, dX_in/dr*, X_up, dX_up/dr*, W at the points r_eval.

        X carries its oscillatory factor relative to r* = rstar(r); the
        constant Wronskian W = X_in d X_up/dr* - X_up d X_in/dr*."""
        r_eval = np.atleast_1d(np.asarray(r_eval, float))
        order = np.argsort(r_eval)
        rg = r_eval[order]
        u_in, fdu_in = self.solve_in(omega, rg)
        u_up, fdu_up = self.solve_up(omega, rg)
        rs = rstar(rg)
        ph_in = np.exp(-1j * omega * rs)
        ph_up = np.exp(+1j * omega * rs)
        X_in = u_in * ph_in
        X_up = u_up * ph_up
        # dX/dr* = (f du/dr -/+ ... ) e^{...}: d/dr* = f d/dr
        dX_in = (fdu_in - 1j * omega * u_in) * ph_in
        dX_up = (fdu_up + 1j * omega * u_up) * ph_up
        W = X_in * dX_up - X_up * dX_in
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        return (
            X_in[inv],
            dX_in[inv],
            X_up[inv],
            dX_up[inv],
            np.mean(W),
            np.max(np.abs(W - np.mean(W))) / np.abs(np.mean(W)),
        )


@functools.lru_cache(maxsize=None)
def homogeneous_rw(l: int) -> Homogeneous:
    return Homogeneous(v_rw(l * (l + 1)))


def v_zerilli(l: int):
    """Zerilli potential (DERIVED as the Darboux partner of V_RW in
    tools/rwz/derive_even.py; loaded from the generated artifact)."""
    from . import generated_even as gen

    V = sp.sympify(gen.V_Z)
    lamval = sp.Rational((l - 1) * (l + 2), 2)
    V = V.subs({sp.Symbol("Lam"): l * (l + 1), sp.Symbol("M", positive=True): 1})
    return sp.cancel(V.subs(sp.Symbol("r"), _R))


@functools.lru_cache(maxsize=None)
def homogeneous_zerilli(l: int) -> Homogeneous:
    return Homogeneous(v_zerilli(l))
