"""Radiation-reaction fluxes and the inspiral ODE right-hand side.

JAX stand-in for the reference engine's ``SchwarzEccFlux`` trajectory
RHS (C++ flux interpolants upstream; behavioral contract pinned at reference
``emri_pe.py:620`` and ``Tutorial_FD_construction_single_mode.ipynb`` cell 5:
``traj(M, mu, 0.0, p0, e0, 1.0, T=T) -> (t, p, e, x, Phi_phi, Phi_theta,
Phi_r)``).

Scheme: a flux-driven hybrid ("kludge") evolution —

* **conservative sector exact**: E(p, e), L(p, e) and (Omega_phi, Omega_r)
  are the exact Schwarzschild-geodesic expressions (`models.geodesic`);
* **dissipative sector post-Newtonian**: orbit-averaged GW fluxes
  <dE/dt>, <dL/dt> at Peters-Mathews order with optional higher-order terms;
* (pdot, edot) follow by inverting the exact 2x2 Jacobian
  d(E, L)/d(p, e) (computed by forward-mode autodiff, so the conservative
  sector stays exactly self-consistent), which reproduces the correct
  separatrix divergence as the Jacobian degenerates at p -> 6 + 2e.

The upstream engine instead interpolates Teukolsky flux data; those data are
not redistributable here, so the flux model is an analytic PN series behind
the same interface (swap `pn_flux_e_l` for a data-driven interpolant to
recover Teukolsky accuracy without touching the integrator or anything
downstream).

Units: time is dimensionless coordinate time per central mass M
(t_sec = t_geo * M * MTSUN_SI); fluxes carry one power of the mass ratio
nu = mu/M.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .geodesic import energy_angmom, fundamental_frequencies, separatrix


def pn_flux_e_l(p: jax.Array, e: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Orbit-averaged specific-energy and angular-momentum fluxes / nu.

    Peters-Mathews (1963/64) quadrupole fluxes expressed in (p, e):
      <dE/dt> = -(32/5) p^-5   (1-e^2)^{3/2} (1 + 73/24 e^2 + 37/96 e^4)
      <dL/dt> = -(32/5) p^-7/2 (1-e^2)^{3/2} (1 + 7/8 e^2)
    with the 1PN (Peters-Mathews -> Junker-Schafer style) correction factors
    applied as a series in 1/p. Higher-order calibration slots in here.
    """
    one_m_e2 = 1.0 - e * e
    fac = one_m_e2 * jnp.sqrt(one_m_e2)
    de = -(32.0 / 5.0) * p**-5 * fac * (1.0 + (73.0 / 24.0) * e * e + (37.0 / 96.0) * e**4)
    dl = -(32.0 / 5.0) * p**-3.5 * fac * (1.0 + (7.0 / 8.0) * e * e)
    return de, dl


def flux_from_modes(
    p, e, table=None, *, tail: bool = False, factorized: bool = False,
    rwz: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """(Edot, Ldot)/nu from the waveform's own multipole content (jittable).

    Energy balance with the table's mode amplitudes: each (l, m, n) harmonic
    radiates dE/dt = (1/16 pi) omega^2 |A|^2 per unit solid-angle-summed
    power, and carries angular momentum L_z/E = m/omega per quantum, so

      <dE/dt>/nu = -(1/8 pi) sum_table omega_mn^2 |A_lmn|^2
      <dL/dt>/nu = -(1/8 pi) sum_table m omega_mn |A_lmn|^2

    (factor 2 from the tabulated m >= 0 half plus equatorial partners).
    This is the dissipative counterpart of the waveform's multipole
    expansion — the trajectory loses exactly the energy the waveform
    carries, through the table's l_max (production l = 6 since round 5;
    the reference engine achieves the analogous
    consistency with Teukolsky flux + amplitude data). Relative to the
    Peters-Mathews quadrupole flux this adds the current-quadrupole /
    octupole / hexadecapole dissipation channels (the leading PN flux
    corrections in the test-mass limit) evaluated on the exact geodesic.
    """
    from .amplitude import default_mode_table, mode_amplitudes

    if table is None:
        table = default_mode_table(30)
    a_re, a_im = mode_amplitudes(p, e, table)
    om_phi, om_r = fundamental_frequencies(p, e)
    m_f = jnp.asarray(table.ms.astype(np.float64))
    n_f = jnp.asarray(table.ns.astype(np.float64))
    om = m_f * om_phi[..., None] + n_f * om_r[..., None]
    power = a_re * a_re + a_im * a_im
    if tail:
        # wave-tail flux enhancement |T_lm|^2 per harmonic; circular-orbit
        # small-x limit reproduces the 4 pi x^{3/2} PN flux tail term
        from .tail import tail_modulus_sq

        power = power * tail_modulus_sq(table.ls, om)
    if factorized:
        # effective source + residual rho_lm resummation (models.rho);
        # with tail=True the circular limit reproduces the test-mass PN
        # flux through x^2 per mode (exact-rational sum rules in
        # tests/test_rho.py: 1 - 1247/336 x + 4 pi x^{3/2} - 44711/9072 x^2)
        from .rho import factorized_correction

        s_rho, _ = factorized_correction(
            table.ls, table.ms, p, e, om, include_delta=False
        )
        power = power * (s_rho * s_rho)
    if rwz:
        # strong-field calibration from the in-repo RWZ solver: per-mode
        # circular-limit fluxes become exact and the eccentric residual
        # table corrects the sidebands (models.rwz_calibration), keeping
        # dissipation energy-balanced with the rwz-corrected amplitudes
        if not (tail and factorized):
            raise ValueError("rwz=True requires tail=True, factorized=True")
        from .amplitude_backends import u_of_pe
        from .rho import _x_of_mode
        from .rwz_calibration import rwz_correction, rwz_ecc_residual

        b = rwz_correction(table.ls, table.ms, _x_of_mode(om, table.ms))
        r_re, r_im = rwz_ecc_residual(
            table.ls, table.ms, table.ns, u_of_pe(p, e), e
        )
        # flux carries |B R|^2 (the phase residual cancels in the power)
        power = power * (b * b) * (r_re * r_re + r_im * r_im)
    inv8pi = 1.0 / (8.0 * jnp.pi)
    de = -inv8pi * jnp.sum(om * om * power, axis=-1)
    dl = -inv8pi * jnp.sum(m_f * om * power, axis=-1)
    return de, dl


class FluxGrid(NamedTuple):
    """Regular (u, e) table of (Edot, Ldot)/nu for the trajectory RHS.

    Mirrors the reference engine's flux-interpolant trajectory backend
    (C++ bicubic over Teukolsky data); here the data is the multipole
    flux, tabulated once host-side and interpolated inside jit.
    """

    u0: float
    du: float
    e0: float
    de: float
    values: jax.Array  # (nu, ne, 2): Edot, Ldot (held as numpy host-side)


def build_flux_grid(
    u_range=None, e_range=(1e-6, 0.78), n_u: int = 96, n_e: int = 49,
    tail: bool = False, factorized: bool = False, rwz: bool = False,
) -> FluxGrid:
    """Tabulate `flux_from_modes` on the (u, e) grid (host-side, once)."""
    from .amplitude_backends import _U_SHIFT

    if u_range is None:
        u_range = (np.log(_U_SHIFT + 0.02), np.log(16.0))
    us = np.linspace(u_range[0], u_range[1], n_u)
    es = np.linspace(e_range[0], e_range[1], n_e)
    uu, ee = np.meshgrid(us, es, indexing="ij")
    pp = np.exp(uu) - _U_SHIFT + 6.0 + 2.0 * ee
    # the first build can be triggered from inside a jit trace (the grid
    # is lru-cached lazily); force compile-time evaluation so the cached
    # table holds concrete arrays, never tracers of a dead trace.
    # The evaluation itself is ONE jitted program (the calibrated stack
    # traces to ~1000 ops, far too many to dispatch one by one), pinned to
    # the host CPU backend: this one-off build is compile-bound, and on an
    # H100 host (700 W limit) the cold rwz grid build took 10.3 s on the
    # GPU against 2.6 s on the CPU.
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:  # pragma: no cover - cpu platform masked
        cpu = None
    with jax.ensure_compile_time_eval(), jax.default_device(cpu):
        de, dl = jax.jit(
            partial(flux_from_modes, tail=tail, factorized=factorized, rwz=rwz)
        )(jnp.asarray(pp.ravel()), jnp.asarray(ee.ravel()))
        vals = jnp.stack(
            [
                jnp.reshape(de, (n_u, n_e)),
                jnp.reshape(dl, (n_u, n_e)),
            ],
            axis=-1,
        )
    # cache PURE NUMPY: a jnp constant created while an outer trace is
    # active would be (or wrap) a tracer of that trace and poison the
    # lru cache; numpy constants are staged per-trace like any closure
    vals = np.asarray(vals)
    return FluxGrid(
        u0=float(us[0]), du=float(us[1] - us[0]),
        e0=float(es[0]), de=float(es[1] - es[0]), values=vals,
    )


@lru_cache(maxsize=8)
def default_flux_grid(
    tail: bool = False, factorized: bool = False, rwz: bool = False
) -> FluxGrid:
    return build_flux_grid(tail=tail, factorized=factorized, rwz=rwz)


def multipole_flux_e_l(p, e, grid: FluxGrid | None = None, dense: bool = False):
    """(Edot, Ldot)/nu by bicubic interpolation of the multipole-flux grid.

    ``dense=False`` (default) uses the 4x4-stencil gather path. The
    ``dense=True`` alternative (`interp2d_bicubic_dense`) evaluates the
    identical Catmull-Rom surface via gather-free cardinal contractions —
    mathematically the same to reduction-order ULPs (pinned by
    ``tests/test_interp2d_dense.py``) — but it is not the production
    default: inside the sequential DP5 ``while_loop`` the per-step query
    batch is tiny (one (p, e) per trajectory lane), so contracting dense
    cardinal vectors against the full (96, 49) grid is latency-bound in
    exactly the spot the 16 stencil gathers were. Dense wins only for
    large query batches against small tables (the rwz-calibration pattern,
    `models/rwz_calibration.py`); it loses for small batches against this
    table. Keep the gather default unless a whole-bench run on the GPU says
    otherwise (ROADMAP Design item 7).
    """
    from ..ops.interp2d import interp2d_bicubic, interp2d_bicubic_dense
    from .amplitude_backends import u_of_pe

    if grid is None:
        grid = default_flux_grid()
    u = u_of_pe(p, e)
    fn = interp2d_bicubic_dense if dense else interp2d_bicubic
    out = fn(
        grid.u0, grid.du, grid.e0, grid.de,
        # stage the numpy-cached table into the active trace as a fresh
        # constant (grid.values stays numpy in the lru cache; see
        # build_flux_grid)
        jnp.asarray(grid.values), u, e,
    )
    return out[..., 0], out[..., 1]


def pdot_edot(p: jax.Array, e: jax.Array, flux_fn=pn_flux_e_l) -> tuple[jax.Array, jax.Array]:
    """(dp/dt, de/dt) per unit mass ratio, via exact-Jacobian flux balance.

    Solves  [dE/dp dE/de; dL/dp dL/de] [pdot; edot] = [Edot; Ldot].
    """
    de_flux, dl_flux = flux_fn(p, e)

    def en(pe):
        return jnp.stack(energy_angmom(pe[0], pe[1]))

    jac = jax.jacfwd(en)(jnp.stack([p, e]))  # (2 [E,L], 2 [p,e])
    det = jac[0, 0] * jac[1, 1] - jac[0, 1] * jac[1, 0]
    pdot = (jac[1, 1] * de_flux - jac[0, 1] * dl_flux) / det
    edot = (-jac[1, 0] * de_flux + jac[0, 0] * dl_flux) / det
    return pdot, edot


class InspiralRHS(NamedTuple):
    """Parameters of the inspiral ODE (static under jit)."""

    nu: jax.Array  # mass ratio mu/M


def inspiral_rhs(state: jax.Array, args: InspiralRHS, flux_fn=pn_flux_e_l) -> jax.Array:
    """RHS of d/dt [p, e, Phi_phi, Phi_r] in geometric time (units of M).

    Matches the reference trajectory's evolved variables (x fixed at 1 and
    Phi_theta unused for Schwarzschild-eccentric, cf. reference notebook
    cell 5 trajectory unpack). ``flux_fn``: dissipative model —
    `pn_flux_e_l` (Peters-Mathews) or `multipole_flux_e_l` (the mode-sum
    flux, energy-balanced with the waveform).
    """
    p, e = state[0], state[1]
    # clamp eccentricity away from exactly 0 for the edot/e terms
    e_safe = jnp.maximum(e, 1.0e-9)
    pdot, edot = pdot_edot(p, e_safe, flux_fn=flux_fn)
    omega_phi, omega_r = fundamental_frequencies(p, e_safe)
    return jnp.stack([args.nu * pdot, args.nu * edot, omega_phi, omega_r])


def stop_condition(state: jax.Array, delta_p_stop: float = 0.12) -> jax.Array:
    """True when the orbit reaches the near-separatrix cutoff.

    The reference engine stops integrating a small offset above
    p_sep = 6 + 2e (Schwarzschild); we use delta_p_stop above it.
    """
    p, e = state[0], state[1]
    return p <= separatrix(e) + delta_p_stop


__all__ = [
    "pn_flux_e_l",
    "flux_from_modes",
    "FluxGrid",
    "build_flux_grid",
    "default_flux_grid",
    "multipole_flux_e_l",
    "pdot_edot",
    "InspiralRHS",
    "inspiral_rhs",
    "stop_condition",
]
