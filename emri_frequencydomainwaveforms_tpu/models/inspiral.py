"""User-facing inspiral trajectory API.

Mirrors the contract of the reference engine's
``few.trajectory.inspiral.EMRIInspiral(func="SchwarzEccFlux")`` as used at
reference ``emri_pe.py:620`` and ``Tutorial_FD_construction_single_mode.ipynb``
cell 5:

    traj(M, mu, a, p0, e0, x0, T=T) -> (t, p, e, x, Phi_phi, Phi_theta, Phi_r)

with ``t`` in seconds at the integrator's own sparse adaptive knots, plus the
root-solving helpers ``get_p_at_t`` / ``get_mu_at_t`` (reference
``emri_pe.py:623-635``, ``check_mode_by_mode.py:201-214``) that fix the
inspiral duration.

Unlike the reference (host Brent loop around a C++ ODE per likelihood call —
its structural bottleneck), everything here is jittable and vmappable: the
whole trajectory is a fixed-budget `lax.while_loop` and the root-solve is a
fixed-count bisection, so batches of sources/walkers integrate in parallel
on-device.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.constants import MTSUN_SI, YRSID_SI
from .flux import InspiralRHS, inspiral_rhs, stop_condition
from .geodesic import separatrix
from .integrate import InspiralKnots, integrate_inspiral


class Trajectory(NamedTuple):
    """Sparse inspiral trajectory (padded static shapes).

    Matches the reference 7-tuple unpack; ``x`` is constant 1 and
    ``Phi_theta`` constant 0 for Schwarzschild-eccentric.
    """

    t: jax.Array  # (max_steps,) seconds
    p: jax.Array
    e: jax.Array
    x: jax.Array
    Phi_phi: jax.Array
    Phi_theta: jax.Array
    Phi_r: jax.Array
    n: jax.Array  # live knot count


@partial(jax.jit, static_argnames=("max_steps", "rtol", "flux", "method"))
def schwarz_ecc_flux_inspiral(
    mass_1: jax.Array,
    mass_2: jax.Array,
    p0: jax.Array,
    e0: jax.Array,
    *,
    t_years: float = 1.0,
    Phi_phi0: jax.Array = 0.0,
    Phi_r0: jax.Array = 0.0,
    max_steps: int = 512,
    rtol: float = 1e-11,
    delta_p_stop: float = 0.12,
    flux: str = "pm",
    method: str = "dp5",
) -> Trajectory:
    """Integrate the Schwarzschild eccentric flux inspiral.

    Args:
      mass_1: central mass M [solar masses].
      mass_2: secondary mass mu [solar masses].
      p0, e0: initial semi-latus rectum / eccentricity.
      t_years: observation horizon T [sidereal years].
      flux: dissipative model — "pm" (Peters-Mathews quadrupole) or
        "multipole" (the l <= 4 mode-sum flux interpolant, energy-balanced
        with the waveform's multipole content; `models.flux.FluxGrid`).

      method: "dp5" (adaptive sequential stepper, the reference-shaped
        path) or "quad" (parallel-in-time p-coordinate quadrature,
        `models.trajectory_quad` — same Trajectory contract, phases agree
        to <~1e-4 rad over full inspirals; ~4x less sequential depth,
        all knots live).

    Returns:
      Trajectory with t in seconds; stops at min(T, separatrix reached).
    """
    if method == "quad":
        from .trajectory_quad import schwarz_ecc_flux_inspiral_quad

        return schwarz_ecc_flux_inspiral_quad(
            mass_1, mass_2, p0, e0, t_years=t_years, Phi_phi0=Phi_phi0,
            Phi_r0=Phi_r0, max_steps=max_steps,
            delta_p_stop=delta_p_stop, flux=flux,
        )
    m = jnp.asarray(mass_1, jnp.float64)
    mu = jnp.asarray(mass_2, jnp.float64)
    nu = mu / m
    t_max_geo = jnp.asarray(t_years, jnp.float64) * YRSID_SI / (m * MTSUN_SI)

    args = InspiralRHS(nu=nu)
    y0 = jnp.stack(
        [
            jnp.asarray(p0, jnp.float64),
            jnp.asarray(e0, jnp.float64),
            jnp.asarray(Phi_phi0, jnp.float64),
            jnp.asarray(Phi_r0, jnp.float64),
        ]
    )
    if flux in ("multipole", "multipole_tail", "multipole_factorized",
                "multipole_rwz"):
        from .flux import default_flux_grid, multipole_flux_e_l

        # "multipole_factorized" = tail + source/rho resummation (the full
        # factorized per-mode flux; models.rho); "multipole_rwz" adds the
        # RWZ strong-field calibration (models.rwz_calibration).
        # The f64 gather bicubic is deliberate (round-4 measurements):
        # an f32 dense-contraction replacement's ~1e-7 quantization broke
        # the adaptive stepper's error control (step-budget saturation),
        # and a 48x32 tensor-Chebyshev fit's inter-node ripple modulated
        # fdot/fddot enough to break the banded/general kernel agreement
        # (6.5e-6 -> 6e-4). The SPA construction differentiates the flux
        # twice through the phase splines — the trajectory flux must be
        # C^1-faithful at f64, which only the bicubic table walk is.
        grid = default_flux_grid(
            tail=(flux != "multipole"),
            factorized=(flux in ("multipole_factorized", "multipole_rwz")),
            rwz=(flux == "multipole_rwz"),
        )
        flux_fn = lambda p_, e_: multipole_flux_e_l(p_, e_, grid)
    else:
        flux_fn = None
    knots: InspiralKnots = integrate_inspiral(
        lambda y: inspiral_rhs(y, args) if flux_fn is None else inspiral_rhs(y, args, flux_fn=flux_fn),
        lambda y: stop_condition(y, delta_p_stop),
        y0,
        t_max_geo,
        max_steps=max_steps,
        rtol=rtol,
        tail_slope_mask=(0.0, 0.0, 1.0, 1.0),  # linear-phase padding
    )
    t_sec = knots.t * (m * MTSUN_SI)
    zeros = jnp.zeros_like(knots.t)
    return Trajectory(
        t=t_sec,
        p=knots.y[:, 0],
        e=knots.y[:, 1],
        x=jnp.ones_like(knots.t),
        Phi_phi=knots.y[:, 2],
        Phi_theta=zeros,
        Phi_r=knots.y[:, 3],
        n=knots.n,
    )


class EMRIInspiral:
    """OO facade pinning the reference trajectory call signature."""

    def __init__(self, func: str = "SchwarzEccFlux", **kwargs):
        if func != "SchwarzEccFlux":
            raise NotImplementedError(f"trajectory model {func!r} not implemented")
        self.kwargs = kwargs

    def __call__(self, M, mu, a, p0, e0, x0, T=1.0, Phi_phi0=0.0, Phi_theta0=0.0, Phi_r0=0.0, **kw):
        del a, x0, Phi_theta0  # Schwarzschild-eccentric: spin/inclination inert
        traj = schwarz_ecc_flux_inspiral(
            M, mu, p0, e0, t_years=float(T), Phi_phi0=Phi_phi0, Phi_r0=Phi_r0,
            **{k: v for k, v in self.kwargs.items() if k in ("max_steps", "rtol")},
        )
        n = int(traj.n)
        return tuple(
            jnp.asarray(arr[:n])
            for arr in (traj.t, traj.p, traj.e, traj.x, traj.Phi_phi, traj.Phi_theta, traj.Phi_r)
        )


@partial(jax.jit, static_argnames=("max_steps", "t_cap_years", "flux"))
def inspiral_duration(
    mass_1, mass_2, p0, e0, *, t_cap_years: float = 8.0, max_steps: int = 512,
    flux: str = "pm",
) -> jax.Array:
    """Seconds until the separatrix cutoff (capped at t_cap_years)."""
    traj = schwarz_ecc_flux_inspiral(
        mass_1, mass_2, p0, e0, t_years=t_cap_years, max_steps=max_steps,
        flux=flux,
    )
    return traj.t[jnp.maximum(traj.n - 1, 0)]


@partial(jax.jit, static_argnames=("max_steps", "n_iters", "flux"))
def get_p_at_t(
    mass_1,
    mass_2,
    e0,
    t_out_years,
    *,
    p_lo: float | None = None,
    p_hi: float = 16.0,
    n_iters: int = 44,
    max_steps: int = 512,
    flux: str = "pm",
) -> jax.Array:
    """p0 such that the inspiral lasts ``t_out_years`` (bisection).

    Pins reference ``get_p_at_t(traj_module, t_out, [M, mu, 0, e0, 1.0],
    ...)`` (``emri_pe.py:623-635``). Vectorized: pass batched masses/e0 via
    `jax.vmap`. Duration increases monotonically with p0, so fixed-count
    bisection converges to ~(p_hi-p_lo)/2^44.
    """
    e0 = jnp.asarray(e0, jnp.float64)
    t_target = jnp.asarray(t_out_years, jnp.float64) * YRSID_SI
    lo = jnp.asarray(p_lo if p_lo is not None else 0.0, jnp.float64)
    lo = jnp.maximum(lo, separatrix(e0) + 0.2)
    hi = jnp.asarray(p_hi, jnp.float64)

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        dur = inspiral_duration(
            mass_1, mass_2, mid, e0, t_cap_years=8.0, max_steps=max_steps,
            flux=flux,
        )
        too_long = dur >= t_target
        return (jnp.where(too_long, lo, mid), jnp.where(too_long, mid, hi))

    lo, hi = jax.lax.fori_loop(0, n_iters, body, (lo, hi))
    return 0.5 * (lo + hi)


@partial(jax.jit, static_argnames=("max_steps", "n_iters"))
def get_mu_at_t(
    mass_1,
    p0,
    e0,
    t_out_years,
    *,
    mu_lo: float = 1.0,
    mu_hi: float = 1e4,
    n_iters: int = 44,
    max_steps: int = 512,
) -> jax.Array:
    """mu such that the inspiral lasts ``t_out_years`` (bisection on mass).

    Larger mu -> faster inspiral -> shorter duration (monotone decreasing).
    Pins reference ``few.utils.utility.get_mu_at_t`` (notebook cell 2 import).
    """
    t_target = jnp.asarray(t_out_years, jnp.float64) * YRSID_SI
    lo = jnp.asarray(mu_lo, jnp.float64)
    hi = jnp.asarray(mu_hi, jnp.float64)

    def body(_, lohi):
        lo, hi = lohi
        mid = jnp.sqrt(lo * hi)  # log bisection
        dur = inspiral_duration(mass_1, mid, p0, e0, t_cap_years=8.0, max_steps=max_steps)
        too_long = dur >= t_target
        # too long -> need faster inspiral -> larger mu
        return (jnp.where(too_long, mid, lo), jnp.where(too_long, hi, mid))

    lo, hi = jax.lax.fori_loop(0, n_iters, body, (lo, hi))
    return jnp.sqrt(lo * hi)


__all__ = [
    "Trajectory",
    "schwarz_ecc_flux_inspiral",
    "EMRIInspiral",
    "inspiral_duration",
    "get_p_at_t",
    "get_mu_at_t",
]
