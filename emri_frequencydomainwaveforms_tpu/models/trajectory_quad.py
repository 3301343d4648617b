"""Quadrature inspiral trajectory: parallel-in-time via the p-coordinate.

A parallel-in-time alternative to the sequential DP5 integrator
(`models.integrate`): the adaptive time-stepper is a ~140-iteration
`lax.while_loop` whose sequential depth — not its flops — sets its cost
on an accelerator. This module removes nearly all of that depth by changing the
independent variable to the semi-latus rectum p (monotone decreasing along
the inspiral):

  * de/dp = edot/pdot is mass-ratio-free, finite THROUGH the separatrix
    approach (both rates carry the same diverging Jacobian factor), and
    smooth — a fixed-step RK4 `lax.scan` with ~64 steps of a scalar ODE
    replaces the 4-state adaptive loop (sequential depth ~256 tiny ops vs
    ~1000 in DP5, with no error-control machinery and no buffer writes);
  * dt/dp = 1/(nu pdot) and dPhi/dp = Omega/(nu pdot) are then explicit
    smooth functions of p (they VANISH linearly at the separatrix, where
    pdot diverges), so t(p) and the phases are cumulative integrals
    evaluated in PARALLEL over all knots: spline the integrands on the
    knot grid and integrate the cubics analytically.

The time horizon is enforced by a second (equally parallel) pass: if the
plunge lies beyond t_max, a fixed-count bisection on the monotone t(p)
spline finds p(t_max) and the knot grid is rebuilt on [p0, p(t_max)].

Knots are uniform in p, which automatically CLUSTERS them in t near the
plunge (dt/dp -> 0 there) — exactly where the phase curvature the
downstream cubic splines must resolve peaks.

Accuracy vs the DP5 reference path (rtol 1e-11) is pinned by
tests/test_trajectory.py: phases agree to <~1e-3 rad over ~1e6 rad at
1 yr — below the FD kernel's own f32 phase-noise floor (~1e-2 rad).

Capability parity: the reference's trajectory contract is
`few.trajectory.EMRIInspiral("SchwarzEccFlux")` (reference emri_pe.py:620);
this module is an alternative backend for `schwarz_ecc_flux_inspiral`
behind the same Trajectory return type.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.cubic_spline import fit_cubic_spline, spline_eval
from ..utils.constants import MTSUN_SI, YRSID_SI
from .flux import pdot_edot, pn_flux_e_l
from .geodesic import fundamental_frequencies

_P_FLOOR = 6.04  # below every possible stop p_sep(e) + delta (e >= 0)


def _clamp_domain(p, e):
    """Keep flux/frequency evaluations above the separatrix: RK stages and
    spline overshoot can probe p < p_sep where the Jacobian determinant
    crosses zero; consumed knots all sit above p_sep + delta_p_stop."""
    e_safe = jnp.clip(e, 1.0e-9, 0.999)
    p_safe = jnp.maximum(p, 6.0 + 2.0 * e_safe + 0.02)
    return p_safe, e_safe


def _de_dp(p, e, flux_fn):
    p_safe, e_safe = _clamp_domain(p, e)
    pdot, edot = pdot_edot(p_safe, e_safe, flux_fn=flux_fn)
    return edot / pdot


def _integrands(p, e, flux_fn):
    """(dt/dp, dPhi_phi/dp, dPhi_r/dp) per unit mass ratio (all negative:
    p decreases while t and the phases increase). Vectorized over knots
    (`pdot_edot`'s exact Jacobian is a scalar-point computation)."""

    def one(pi, ei):
        p_safe, e_safe = _clamp_domain(pi, ei)
        pdot, _ = pdot_edot(p_safe, e_safe, flux_fn=flux_fn)
        om_phi, om_r = fundamental_frequencies(p_safe, e_safe)
        inv = 1.0 / pdot
        return inv, om_phi * inv, om_r * inv

    return jax.vmap(one)(p, e)


def _cumulative_spline_integral(x, ys):
    """Cumulative integrals of each row of ``ys`` sampled at ``x``.

    Fits a not-a-knot cubic through the samples and integrates the cubics
    analytically — one batched tridiagonal solve + closed-form segment
    integrals, no sequential loop. ``x`` strictly increasing. Returns an
    array like ``ys`` with [..., 0] = 0.
    """
    h = jnp.diff(x)
    sp = fit_cubic_spline(x, ys, bc="not-a-knot")
    c0 = sp.c[..., 0]
    c1 = sp.c[..., 1]
    c2 = sp.c[..., 2]
    c3 = sp.c[..., 3]
    # segment integral of c0 + c1 u + c2 u^2 + c3 u^3 over u in [0, h]
    seg = h * (c0 + h * (c1 / 2.0 + h * (c2 / 3.0 + h * c3 / 4.0)))
    zero = jnp.zeros(ys.shape[:-1] + (1,), ys.dtype)
    return jnp.concatenate([zero, jnp.cumsum(seg, axis=-1)], axis=-1)


def _solve_e_of_p(p0, e0, flux_fn, n_seq: int):
    """Fixed-step RK4 of de/dp from p0 down to the _P_FLOOR grid.

    Returns (p_grid desc (n_seq+1,), e_grid). Steps below the separatrix
    region freeze (the crossing is interpolated by the caller; values past
    it are never consumed).
    """
    h = (_P_FLOOR - p0) / n_seq  # negative

    def step(carry, _):
        p, e = carry
        k1 = _de_dp(p, e, flux_fn)
        k2 = _de_dp(p + 0.5 * h, e + 0.5 * h * k1, flux_fn)
        k3 = _de_dp(p + 0.5 * h, e + 0.5 * h * k2, flux_fn)
        k4 = _de_dp(p + h, e + h * k3, flux_fn)
        de = (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        # freeze once inside the unstable region (p < p_sep + small): the
        # flux Jacobian det changes sign there and the ODE leaves its
        # domain of validity; frozen values are never consumed
        unstable = p + h <= 6.0 + 2.0 * e
        e_new = jnp.where(unstable, e, jnp.clip(e + de, 0.0, 0.999))
        return (p + h, e_new), e_new

    (_, _), e_hist = jax.lax.scan(step, (p0, e0), None, length=n_seq)
    p_grid = p0 + h * jnp.arange(n_seq + 1, dtype=p0.dtype)
    e_grid = jnp.concatenate([e0[None], e_hist])
    return p_grid, e_grid


def _find_stop(p_grid, e_grid, delta_p_stop):
    """Interpolated root of phi(p) = p - (6 + 2 e(p) + delta) (the
    separatrix stop surface), scanning the descending grid."""
    phi = p_grid - (6.0 + 2.0 * e_grid + delta_p_stop)
    # first index (in descent order) where phi <= 0; phi[0] > 0 for any
    # orbit that starts outside the stop surface
    crossed = phi <= 0.0
    idx = jnp.argmax(crossed)  # first True
    idx = jnp.clip(idx, 1, p_grid.shape[0] - 1)
    ph_a, ph_b = phi[idx - 1], phi[idx]
    w = ph_a / jnp.maximum(ph_a - ph_b, 1e-300)
    p_stop = p_grid[idx - 1] + w * (p_grid[idx] - p_grid[idx - 1])
    any_cross = jnp.any(crossed)
    return jnp.where(any_cross, p_stop, p_grid[-1])


@partial(jax.jit, static_argnames=("max_steps", "n_seq", "flux"))
def schwarz_ecc_flux_inspiral_quad(
    mass_1,
    mass_2,
    p0,
    e0,
    *,
    t_years: float = 1.0,
    Phi_phi0=0.0,
    Phi_r0=0.0,
    max_steps: int = 192,
    n_seq: int = 96,
    delta_p_stop: float = 0.12,
    flux: str = "pm",
):
    """Quadrature-trajectory drop-in for `schwarz_ecc_flux_inspiral`.

    Returns the same `Trajectory` NamedTuple (all ``max_steps`` knots live,
    the last knot at min(plunge, t_max)).
    """
    from .inspiral import Trajectory

    m = jnp.asarray(mass_1, jnp.float64)
    mu = jnp.asarray(mass_2, jnp.float64)
    nu = mu / m
    p0 = jnp.asarray(p0, jnp.float64)
    e0 = jnp.asarray(e0, jnp.float64)
    t_max_geo = jnp.asarray(t_years, jnp.float64) * YRSID_SI / (m * MTSUN_SI)

    if flux in ("multipole", "multipole_tail", "multipole_factorized",
                "multipole_rwz"):
        from .flux import default_flux_grid, multipole_flux_e_l

        grid = default_flux_grid(
            tail=(flux != "multipole"),
            factorized=(flux in ("multipole_factorized", "multipole_rwz")),
            rwz=(flux == "multipole_rwz"),
        )
        flux_fn = lambda p_, e_: multipole_flux_e_l(p_, e_, grid)
    else:
        flux_fn = pn_flux_e_l

    # ---- sequential part: e(p) on the coarse grid ----
    p_seq, e_seq = _solve_e_of_p(p0, e0, flux_fn, n_seq)
    p_stop = _find_stop(p_seq, e_seq, delta_p_stop)
    e_sp = fit_cubic_spline(p_seq[::-1], e_seq[::-1], bc="not-a-knot")

    def build(p_end):
        """Knots uniform in p on [p0, p_end] + parallel integrals."""
        frac = jnp.arange(max_steps, dtype=jnp.float64) / (max_steps - 1)
        p_k = p0 + (p_end - p0) * frac  # descending
        e_k = jnp.clip(spline_eval(e_sp, p_k), 0.0, 0.999)
        f_t, f_phi, f_r = _integrands(p_k, e_k, flux_fn)
        ints = _cumulative_spline_integral(
            p_k[::-1], jnp.stack([f_t[::-1], f_phi[::-1], f_r[::-1]])
        )
        # F(x_j) = int_{p_end}^{x_j} f dx (ascending). The integrands are
        # negative, so t(p) = int_{p0}^{p} f = F(p) - F(p0) >= 0; reverse
        # back to the descending knot order (= increasing time).
        t_geo = (ints[0] - ints[0, -1])[::-1] / nu
        phi_phi = (ints[1] - ints[1, -1])[::-1] / nu
        phi_r = (ints[2] - ints[2, -1])[::-1] / nu
        return p_k, e_k, t_geo, phi_phi, phi_r

    # pass 1: plunge-bounded grid
    p_k, e_k, t_geo, phi_phi, phi_r = build(p_stop)
    t_end = t_geo[-1]

    # pass 2 (branch-free): if the horizon t_max lands before the plunge,
    # find p(t_max) by bisection on the monotone t(p) map and rebuild
    def t_of_p(p_q):
        # recompute t via the same integrand spline (cheap, parallel)
        f_sp = fit_cubic_spline(p_k[::-1], t_geo[::-1], bc="not-a-knot")
        return spline_eval(f_sp, p_q)

    def bisect(_):
        lo, hi = p_stop, p0  # t(lo) = t_end >= t_max > 0 = t(hi)

        def body(_, lohi):
            lo, hi = lohi
            mid = 0.5 * (lo + hi)
            too_late = t_of_p(mid) >= t_max_geo
            return (jnp.where(too_late, mid, lo), jnp.where(too_late, hi, mid))

        lo, hi = jax.lax.fori_loop(0, 40, body, (lo, hi))
        return 0.5 * (lo + hi)

    p_cut = jax.lax.cond(t_end > t_max_geo, bisect, lambda _: p_stop, None)
    p_k, e_k, t_geo, phi_phi, phi_r = build(p_cut)

    t_sec = t_geo * (m * MTSUN_SI)
    zeros = jnp.zeros_like(t_sec)
    return Trajectory(
        t=t_sec,
        p=p_k,
        e=e_k,
        x=jnp.ones_like(t_sec),
        Phi_phi=phi_phi + jnp.asarray(Phi_phi0, jnp.float64),
        Phi_theta=zeros,
        Phi_r=phi_r + jnp.asarray(Phi_r0, jnp.float64),
        n=jnp.asarray(max_steps, jnp.int32),
    )


__all__ = ["schwarz_ecc_flux_inspiral_quad"]
