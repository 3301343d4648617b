"""Multipole mode amplitudes A_lmn(p, e) through l = 4, on the fly.

Replaces the reference engine's amplitude backends
(``few.amplitude.romannet.RomanAmplitude`` — a CUDA MLP over reduced-order
Teukolsky data — and ``few.amplitude.interp2dcubicspline.Interp2DAmplitude``;
call contract pinned at reference ``Tutorial_FD_construction_single_mode.ipynb``
cells 5, 19, 26: ``amp(p, e, specific_modes=[(l, m, n)]) -> complex A along
the trajectory``). The upstream Teukolsky datasets are not redistributable,
so this module computes the amplitudes from first principles over the
*exact relativistic orbit* (geodesic r(chi), phi(chi), t(chi) from
`models.geodesic`) using the flat-space radiative multipole expansion
through l = 4 — mass quadrupole/octupole/hexadecapole plus current
quadrupole/octupole (Thorne 1980 eq. 4.8) — which preserves the full
(l, m, n) harmonic structure the FD summation needs. Calibrated Teukolsky
data drops into the same interface when available.

Structure (equatorial orbit, G = c = 1, central mass M = 1, reduced mass mu
and the reference distance factor ``mu MRSUN_SI/(dist Gpc)`` applied by the
detector-frame wrapper): in the convention

  h = h_+ - i h_x = sum_{lmn} A_lmn (-2)Y_lm(Th, Ph) e^{-i(m Phi_phi + n Phi_r)},

every family reduces to

  A_lmn = C_lm * omega_mn^l * F_n[g_lm],   omega_mn = m Omega_phi + n Omega_r,

with F_n the radial-harmonic Fourier coefficient of the orbit functional
g_lm over one radial period (all F_n are REAL by the chi -> -chi parity of
the Darwin orbit) and constants C_lm = K_lm (-i)^l derived EXACTLY from
Thorne eq. 4.8 by spectral projection (``tools/derive_multipoles.py``;
residuals ~1e-12, values snap to closed forms):

  family  g_lm            C_lm
  (2,2)   r^2 e^{2i dphi}   -2 sqrt(pi/5)
  (2,0)   r^2               +sqrt(8 pi/15)
  (2,1)   l r e^{i dphi}    +i sqrt(64 pi/45)     (current quadrupole)
  (3,3)   r^3 e^{3i dphi}   -i sqrt(2 pi/189)
  (3,1)   r^3 e^{i dphi}    +i sqrt(2 pi/315)
  (3,2)   l r^2 e^{2i dphi} -sqrt(pi/63)          (current octupole)
  (3,0)   l r^2             +sqrt(2 pi/105)
  (4,4)   r^4 e^{4i dphi}   +sqrt(pi/9072)
  (4,2)   r^4 e^{2i dphi}   -sqrt(pi/15876)
  (4,0)   r^4               +sqrt(pi/17640)

with l(t) = r^2 dphi/dt the specific angular momentum and dphi = phi -
Omega_phi t the periodic azimuth. Negative-m partners follow from the
standard planar-system symmetry A_{l,-m,-n} = (-1)^l conj(A_{l,m,n}) for
ALL families: the current families' purely imaginary C_lm supply the
(-1)^{l+1} z-parity of B-type radiation under conjugation.

The Fourier projections are spectrally-convergent trapezoid sums over the
Darwin angle, evaluated in f32 end-to-end (amplitude precision ~1e-6
relative — orders below the 1e-4 mismatch gate; waveform PHASES never pass
through this module): the periodic antiderivatives t(chi), phi(chi) and the
(knots, rows) x (rows, harmonics) projection are batched f32 matmuls at
``Precision.HIGHEST`` (full f32 on the GPU; a default-precision f32 matmul
may run in TF32). The f32 choice was made for an accelerator with emulated
f64 (ROADMAP Design item 2).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .geodesic import _N_CHI, _antiderivative_matrix, darwin_orbit

_SQRT_PI_5 = float(np.sqrt(np.pi / 5.0))
_SQRT_8PI_15 = float(np.sqrt(8.0 * np.pi / 15.0))

# (l, m) -> (azimuthal k of g_lm, r power, ell power, C_re, C_im); see
# module docstring + tools/derive_multipoles.py. Round 3 extends the
# inventory through l = 6: current hexadecapole (4,3)/(4,1), the l = 5
# mass 2^5-pole + current 2^5-pole, and the l = 6 mass 2^6-pole + current
# 2^6-pole families, constants fit against the generic-STF Thorne-4.8
# brute force to ~1e-11 residuals (K_60/K_63/K_61 kept as full-precision
# numerics where |K|^2/pi does not snap to a small rational).
_FAMILIES = {
    (2, 2): (2, 2, 0, -2.0 * np.sqrt(np.pi / 5.0), 0.0),
    (2, 0): (0, 2, 0, +np.sqrt(8.0 * np.pi / 15.0), 0.0),
    (2, 1): (1, 1, 1, 0.0, +np.sqrt(64.0 * np.pi / 45.0)),
    (3, 3): (3, 3, 0, 0.0, -np.sqrt(2.0 * np.pi / 189.0)),
    (3, 1): (1, 3, 0, 0.0, +np.sqrt(2.0 * np.pi / 315.0)),
    (3, 2): (2, 2, 1, -np.sqrt(np.pi / 63.0), 0.0),
    (3, 0): (0, 2, 1, +np.sqrt(2.0 * np.pi / 105.0), 0.0),
    (4, 4): (4, 4, 0, +np.sqrt(np.pi / 9072.0), 0.0),
    (4, 2): (2, 4, 0, -np.sqrt(np.pi / 15876.0), 0.0),
    (4, 0): (0, 4, 0, +np.sqrt(np.pi / 17640.0), 0.0),
    # current hexadecapole (l = 4 B-type)
    (4, 3): (3, 3, 1, 0.0, -np.sqrt(2.0 * np.pi / 14175.0)),
    (4, 1): (1, 3, 1, 0.0, +np.sqrt(2.0 * np.pi / 11025.0)),
    # l = 5 mass 2^5-pole  (C = K (-i)^5 = -i K: fit K real -> C imaginary)
    (5, 5): (5, 5, 0, 0.0, +np.sqrt(np.pi / 1188000.0)),
    (5, 3): (3, 5, 0, 0.0, -np.sqrt(np.pi / 2138400.0)),
    (5, 1): (1, 5, 0, 0.0, +np.sqrt(np.pi / 2494800.0)),
    # l = 5 current 2^5-pole  (fit K imaginary -> C real)
    (5, 4): (4, 4, 1, +np.sqrt(np.pi / 1069200.0), 0.0),
    (5, 2): (2, 4, 1, -np.sqrt(np.pi / 801900.0), 0.0),
    (5, 0): (0, 4, 1, +np.sqrt(np.pi / 748440.0), 0.0),
    # l = 6 mass 2^6-pole  (C = K (-i)^6 = -K)
    (6, 6): (6, 6, 0, -np.sqrt(np.pi / 208494000.0), 0.0),
    (6, 4): (4, 6, 0, +np.sqrt(np.pi / 382239000.0), 0.0),
    (6, 2): (2, 6, 0, -np.sqrt(np.pi / 458686800.0), 0.0),
    (6, 0): (0, 6, 0, +8.0764808368e-05, 0.0),
    # l = 6 current 2^6-pole
    (6, 5): (5, 5, 1, 0.0, +np.sqrt(np.pi / 212837625.0)),
    (6, 3): (3, 5, 1, 0.0, -1.41873087857e-04),
    (6, 1): (1, 5, 1, 0.0, +1.49547365463e-04),
    # l = 7 mass 2^7-pole (C = K (-i)^7 = +i K: K real -> C imaginary);
    # round 4, Thorne-4.8 coefficient 4/7! = 1/1260, fit residuals ~9e-11
    # (full-precision numerics: pi/K^2 does not snap cleanly at f64 fit
    # precision; (7,7) is consistent with sqrt(pi/47675628000))
    (7, 7): (7, 7, 0, 0.0, -8.117582762081e-06),
    (7, 5): (5, 7, 0, 0.0, +5.956677244179e-06),
    (7, 3): (3, 7, 0, 0.0, -5.388017293582e-06),
    (7, 1): (1, 7, 0, 0.0, +5.184621961820e-06),
    # l = 7 current 2^7-pole (coefficient 8*7/8! = 1/720; K imaginary ->
    # C = i K real)
    (7, 6): (6, 6, 1, -7.593303376034e-06, 0.0),
    (7, 4): (4, 6, 1, +8.935015866033e-06, 0.0),
    (7, 2): (2, 6, 1, -9.524758893299e-06, 0.0),
    (7, 0): (0, 6, 1, +9.699539140288e-06, 0.0),
    # l = 8 mass 2^8-pole (C = K (-i)^8 = K; coefficient 4/8! = 1/10080)
    (8, 8): (8, 8, 0, +4.765713291088e-07, 0.0),
    (8, 6): (6, 8, 0, -3.480384896283e-07, 0.0),
    (8, 4): (4, 8, 0, +3.127881196656e-07, 0.0),
    (8, 2): (2, 8, 0, -2.982317661474e-07, 0.0),
    (8, 0): (0, 8, 0, +2.940620600128e-07, 0.0),
    # l = 8 current 2^8-pole (coefficient 8*8/9! = 1/5670)
    (8, 7): (7, 7, 1, 0.0, -4.236189592099e-07),
    (8, 5): (5, 7, 1, 0.0, +5.012327120486e-07),
    (8, 3): (3, 7, 1, 0.0, -5.384103027786e-07),
    (8, 1): (1, 7, 1, 0.0, +5.544861311315e-07),
    # l = 9 mass 2^9-pole (round 5; C = K (-i)^9 = -i K: K real ->
    # C imaginary; Thorne coefficient 4/9! = 1/90720, fit residual 9e-10)
    (9, 9): (9, 9, 0, 0.0, +2.512567346957e-08),
    (9, 7): (7, 9, 0, 0.0, -1.828161275733e-08),
    (9, 5): (5, 9, 0, 0.0, +1.635157155513e-08),
    (9, 3): (3, 9, 0, 0.0, -1.549033288529e-08),
    (9, 1): (1, 9, 0, 0.0, +1.513427644922e-08),
    # l = 9 current 2^9-pole (coefficient 8*9/10! = 1/50400; K imaginary
    # -> C = K_im real; fit residual 3e-9)
    (9, 8): (8, 8, 1, +2.131984091075e-08, 0.0),
    (9, 6): (6, 8, 1, -2.533174571240e-08, 0.0),
    (9, 4): (4, 8, 1, +2.736141264720e-08, 0.0),
    (9, 2): (2, 8, 1, -2.839421719954e-08, 0.0),
    (9, 0): (0, 8, 1, +2.872401546235e-08, 0.0),
    # l = 10 mass 2^10-pole (C = K (-i)^10 = -K; coefficient 4/10! =
    # 1/907200, fit residual 5e-9)
    (10, 10): (10, 10, 0, -1.201236950368e-09, 0.0),
    (10, 8): (8, 10, 0, +8.714688780084e-10, 0.0),
    (10, 6): (6, 10, 0, -7.765944547675e-10, 0.0),
    (10, 4): (4, 10, 0, +7.321844397109e-10, 0.0),
    (10, 2): (2, 10, 0, -7.108479184447e-10, 0.0),
    (10, 0): (0, 10, 0, +7.005353442900e-10, 0.0),
    # l = 10 current 2^10-pole (coefficient 8*10/11! = 1/498960; C =
    # -i K_im; fit residual 1.4e-8)
    (10, 9): (9, 9, 1, 0.0, +9.767445375104e-10),
    (10, 7): (7, 9, 1, 0.0, -1.164356770166e-09),
    (10, 5): (5, 9, 1, 0.0, +1.262922175499e-09),
    (10, 3): (3, 9, 1, 0.0, -1.317858933793e-09),
    (10, 1): (1, 9, 1, 0.0, +1.343086309739e-09),
}
_FAMILY_ORDER = list(_FAMILIES)


class ModeTable(NamedTuple):
    """Static (l, m, n) mode inventory (host-side numpy; fixed at trace time).

    Only m >= 0 modes are tabulated; the summation applies the equatorial
    conjugate symmetry for -m (same convention as the reference's
    ``assume_positive_m`` / ``include_minus_m`` machinery).
    """

    ls: np.ndarray
    ms: np.ndarray
    ns: np.ndarray

    @property
    def num_modes(self) -> int:
        return len(self.ls)

    def take(self, idx) -> "ModeTable":
        """Static (host-side) sub-table of the given candidate indices.

        The production fast path slices the table to a frozen mode
        selection BEFORE the prologue so amplitudes/Ylm evaluate only for
        the kept modes (16 of the 519 candidates at the bench
        configuration).
        Pass the SAME sliced table to the summation kernels with
        ``forced_idx=np.arange(len(idx))``.
        """
        idx = np.asarray(idx)
        return ModeTable(ls=self.ls[idx], ms=self.ms[idx], ns=self.ns[idx])


def default_mode_table(n_max: int = 30, l_max: int = 6) -> ModeTable:
    """Multipole inventory through ``l_max`` (families in _FAMILIES;
    l_max up to 10 since round 5 — 63 (l, m) families, matching the
    reference inventory's l <= 10 reach). The production default is
    l_max = 6 (round 5): the measured l4-vs-l6 FD mismatch reaches 1.1e-3
    for high-e draws — above the repo's 1e-4 accuracy gate — while
    l6-vs-l8 is <= 1.1e-5 (PARITY.md; tools/convergence_l56.py), so l = 6
    is the first rung under the gate across the PE prior. l = 7..10 stay
    available for convergence studies. Reference inventory:
    RomanAmplitude's 3843 modes through l = 10 (reference
    Tutorial_FD_construction_single_mode.ipynb cell 2).

    m > 0 families carry n in [-n_max, n_max]; m = 0 families carry
    n in [1, n_max] (their negative-n partners follow from reality).
    """
    ls, ms, ns = [], [], []
    for (l, m) in _FAMILY_ORDER:
        if l > l_max:
            continue
        n_range = range(1, n_max + 1) if m == 0 else range(-n_max, n_max + 1)
        for n in n_range:
            ls.append(l)
            ms.append(m)
            ns.append(n)
    return ModeTable(np.array(ls), np.array(ms), np.array(ns))


def _orbit_harmonics(p, e, n_max: int, fam_subset: tuple[int, ...] | None = None):
    """Fourier coefficients F_n[g_lm] of the requested multipole families.

    ``p``, ``e``: any shape, flattened internally to a (BK,) batch.
    ``fam_subset``: static tuple of indices into ``_FAMILY_ORDER`` (None =
    all 63 families); restricting to the table's families keeps the
    production configuration at its original row count. Returns ``f_fam``
    f32 of shape (..., len(subset), 2*n_max+1) indexed by (subset order,
    n = -n_max..n_max), plus (omega_phi, omega_r) f32 of shape (...,).
    All coefficients are real (chi-parity; module docstring).

    One batched (rows, n_chi) x (n_chi, 2(n_max+1)) f32 matmul per knot
    serves every harmonic of every family at once.
    """
    if fam_subset is None:
        fam_subset = tuple(range(len(_FAMILY_ORDER)))
    shape = np.shape(p)
    f32 = jnp.float32
    n_chi = _N_CHI
    p32 = jnp.reshape(jnp.asarray(p), (-1,)).astype(f32)[:, None]  # (BK, 1)
    e32 = jnp.reshape(jnp.asarray(e), (-1,)).astype(f32)[:, None]

    chi = (2.0 * np.pi / n_chi) * np.arange(n_chi)
    cos_chi = jnp.asarray(np.cos(chi), f32)[None, :]
    chi32 = jnp.asarray(chi, f32)[None, :]

    ecos = e32 * cos_chi
    rad = p32 - 6.0 - 2.0 * ecos
    r = p32 / (1.0 + ecos)
    dphi_dchi = jnp.sqrt(p32 / rad)
    dt_dchi = (
        p32 * p32 * jnp.sqrt((p32 - 2.0) ** 2 - 4.0 * e32 * e32)
        / ((p32 - 2.0 - 2.0 * ecos) * (1.0 + ecos) ** 2 * jnp.sqrt(rad))
    )
    h = f32(2.0 * np.pi / n_chi)
    t_r = jnp.sum(dt_dchi, axis=-1, keepdims=True) * h  # (BK, 1)
    dphi_tot = jnp.sum(dphi_dchi, axis=-1, keepdims=True) * h
    omega_r = 2.0 * np.pi / t_r
    omega_phi = dphi_tot / t_r

    # periodic antiderivatives: one shared (n_chi, n_chi) f32 operator.
    # Kept SPLIT as (periodic part, mean) — the periodic parts are O(e)-small
    # and stay accurate in f32 where the assembled t(chi) (magnitude T_r)
    # would lose ~1e-4 s to representation alone.
    a_op_t = jnp.asarray(_antiderivative_matrix(n_chi).T, f32)

    def periodic_antiderivative(g):
        mean = jnp.mean(g, axis=-1, keepdims=True)
        gint = jax.lax.dot_general(
            g - mean, a_op_t, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
        return gint, mean

    t_per, t_mean = periodic_antiderivative(dt_dchi)  # t = t_mean*chi + t_per
    phi_per, phi_mean = periodic_antiderivative(dphi_dchi)

    # periodic azimuth: dphi = phi - omega_phi t
    #   = phi_per - omega_phi t_per + (phi_mean - omega_phi t_mean) chi,
    # and the chi coefficient vanishes identically (omega_phi = phi_mean /
    # t_mean), so assemble from the SMALL parts only
    dphi = phi_per - omega_phi * t_per
    w = dt_dchi * (h / t_r)  # sums to 1

    # orbit functional building blocks: r powers, specific angular momentum
    # l = r^2 dphi/dt, and cos/sin(k dphi) by Chebyshev-style recurrence
    ell = (r * r) * dphi_dchi / dt_dchi
    # highest azimuthal harmonic / r power any REQUESTED family needs
    # (k, r power reach 10 for the l = 10 inventory; building only what
    # the subset uses keeps the production l <= 6 path at its row count)
    k_top = max(_FAMILIES[_FAMILY_ORDER[i]][0] for i in fam_subset)
    rp_top = max(_FAMILIES[_FAMILY_ORDER[i]][1] for i in fam_subset)
    c1, s1 = jnp.cos(dphi), jnp.sin(dphi)
    ck = {0: (jnp.ones_like(c1), jnp.zeros_like(s1)), 1: (c1, s1)}
    for k in range(2, max(k_top, 1) + 1):
        cprev, sprev = ck[k - 1]
        ck[k] = (cprev * c1 - sprev * s1, sprev * c1 + cprev * s1)
    rpow = {1: r}
    for rp in range(2, max(rp_top, 1) + 1):
        rpow[rp] = rpow[rp - 1] * r

    def fval(rp, lp):
        base = rpow[rp]
        return ell * base if lp else base

    # harmonic basis e^{-i n theta}, theta = Omega_r t(chi) = chi + theta_per
    # with theta_per = t_per / t_mean (|.| < ~2 pi e, exact split since
    # Omega_r t_mean = 1 identically). n*theta reaches ~190 rad where f32
    # resolution is ~1.5e-5 rad — enough basis-phase error to leak the large
    # low-n integrand components into the small high-n coefficients. Split
    # exactly instead:
    #   * n*chi_j mod 2pi is EXACT integer arithmetic on the uniform grid
    #     (host-precomputed cos/sin tables);
    #   * theta_per splits Cody-Waite style into a 2^-13-quantized head
    #     (n*head is EXACT in f32 for n <= 2^10, range-reduced with a
    #     two-term 2pi) plus a <=2^-14 tail whose n-fold product is benign;
    #   * combine via the angle-addition identity.
    theta_per = t_per / t_mean  # (BK, n_chi)
    th_hi = jnp.round(theta_per * 8192.0) * f32(1.0 / 8192.0)
    th_lo = theta_per - th_hi
    n_np = np.arange(n_max + 1)
    ang_grid = 2.0 * np.pi * ((n_np[None, :] * np.arange(n_chi)[:, None]) % n_chi) / n_chi
    cos_a = jnp.asarray(np.cos(ang_grid), f32)[None]  # (1, n_chi, n_max+1)
    sin_a = jnp.asarray(np.sin(ang_grid), f32)[None]
    n_arr = jnp.asarray(n_np, f32)
    two_pi_hi = f32(6.28125)  # exact in 8 bits: 2pi = hi + lo
    two_pi_lo = f32(2.0 * np.pi - 6.28125)
    ang_hi = th_hi[:, :, None] * n_arr[None, None, :]  # exact products
    k = jnp.round(ang_hi * f32(1.0 / (2.0 * np.pi)))
    b_small = (ang_hi - k * two_pi_hi) - k * two_pi_lo + th_lo[:, :, None] * n_arr
    cos_b = jnp.cos(b_small)
    sin_b = jnp.sin(b_small)
    cs = jnp.concatenate(
        [cos_a * cos_b - sin_a * sin_b, sin_a * cos_b + cos_a * sin_b], axis=-1
    )
    # One integrand row pair per family: f cos(k dphi) and (k > 0 only)
    # f sin(k dphi). By the chi -> -chi parity of the Darwin orbit the
    # coefficients F_n = sum w f e^{i(k dphi - n theta)} are REAL:
    # F_{+-n} = sum w f cos(k dphi) cos(n theta) +- sum w f sin(k dphi)
    # sin(n theta). Cos rows have their DC subtracted before projection (the
    # n=0 component is ~30x the rest and residual basis-phase noise couples
    # it into every harmonic; the mean contributes exactly delta_{n0} and is
    # restored after); sin-row DCs vanish by parity.
    rows = []
    row_meta = []  # (subset position, which: 0 cos / 1 sin)
    means = []
    for si, fi in enumerate(fam_subset):
        k, rp, lp, _, _ = _FAMILIES[_FAMILY_ORDER[fi]]
        f_vals = fval(rp, lp)
        ckk, skk = ck[k]
        fc = f_vals * ckk
        mc = jnp.sum(w * fc, axis=-1, keepdims=True)
        rows.append(w * (fc - mc))
        row_meta.append((si, 0))
        means.append(mc)
        if k > 0:
            rows.append(w * (f_vals * skk))
            row_meta.append((si, 1))
    integ = jnp.stack(rows, axis=1)  # (BK, n_rows, n_chi)
    proj = jax.lax.dot_general(
        integ, cs, (((2,), (1,)), ((0,), (0,))),
        precision=jax.lax.Precision.HIGHEST,
    )  # (BK, n_rows, 2(n_max+1))

    np1 = n_max + 1
    dc = jnp.concatenate([jnp.ones((1,), f32), jnp.zeros((np1 - 1,), f32)])[None, :]
    n_fam = len(fam_subset)
    cos_part = [None] * n_fam
    sin_part = [jnp.zeros_like(proj[:, 0, np1:])] * n_fam
    mi = 0
    for ri, (si, which) in enumerate(row_meta):
        if which == 0:
            cos_part[si] = proj[:, ri, :np1] + means[mi] * dc
            mi += 1
        else:
            sin_part[si] = proj[:, ri, np1:]
    f_all = []
    for fi in range(n_fam):
        wc, ws = cos_part[fi], sin_part[fi]
        # n = -n_max..-1 (reversed wc - ws tail), then 0..n_max (wc + ws)
        f_all.append(
            jnp.concatenate([(wc - ws)[:, 1:][:, ::-1], wc + ws], axis=-1)
        )
    f_fam = jnp.stack(f_all, axis=1)  # (BK, n_fam, 2 n_max + 1)

    def unflatten(x):
        return jnp.reshape(x, shape + x.shape[1:])

    return (
        unflatten(f_fam),
        unflatten(omega_phi[:, 0]),
        unflatten(omega_r[:, 0]),
    )


def mode_amplitudes(
    p: jax.Array, e: jax.Array, table: ModeTable,
    *, tail: bool = False, tail_r0: float = 2.0,
    factorized: bool = False, rwz: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """A_lmn(p, e) for every mode in ``table`` -> (re, im), shape (..., n_modes).

    ``p``/``e`` may be arrays (trajectory knots, batches); the mode axis is
    appended last. Covers every (l, m) family in ``_FAMILIES`` (l <= 4 mass
    + current multipoles); other modes return 0 (the interface accepts the
    full generic inventory so richer amplitude backends can swap in).

    ``tail=True`` multiplies each harmonic by the factorized relativistic
    tail factor T_lm(omega_mn) (`models.tail`) — closed-form wave-tail
    amplification validated against the known 2 pi x^{3/2} PN amplitude
    term (the reference's Teukolsky amplitudes carry this content;
    notebook cell 2 `RomanAmplitude`).

    ``factorized=True`` additionally applies the effective source and the
    residual relativistic correction S_hat * rho_lm(x_mn)^l * e^{i delta}
    (`models.rho`) — the remaining pieces of the factorized resummation.
    Full amplitude fidelity = ``tail=True, factorized=True`` (together
    they reproduce the published test-mass per-mode PN amplitude/flux
    series through the anchored orders; tests/test_rho.py).
    """
    n_max = int(np.max(np.abs(table.ns))) if table.num_modes else 0

    # static per-mode bookkeeping (host numpy; compiles to slice-selects)
    fam_lookup = {lm: i for i, lm in enumerate(_FAMILY_ORDER)}
    fam_idx = np.array(
        [fam_lookup.get((int(l), int(m)), -1) for l, m in zip(table.ls, table.ms)]
    )
    known = fam_idx >= 0
    fam_idx_safe = np.where(known, fam_idx, 0)
    # only the families present in the table are projected (static subset;
    # keeps the l<=4 production row count when higher-l families exist)
    fam_subset = tuple(sorted(set(fam_idx_safe.tolist())))
    sub_pos = {fi: si for si, fi in enumerate(fam_subset)}
    fam_pos = np.array([sub_pos[fi] for fi in fam_idx_safe])

    f_fam, omega_phi, omega_r = _orbit_harmonics(p, e, n_max, fam_subset)

    n_idx = table.ns + n_max
    c_re = np.array([_FAMILIES[lm][3] for lm in _FAMILY_ORDER])[fam_idx_safe]
    c_im = np.array([_FAMILIES[lm][4] for lm in _FAMILY_ORDER])[fam_idx_safe]
    c_re = np.where(known, c_re, 0.0)
    c_im = np.where(known, c_im, 0.0)

    # F_n gather: one fancy-index over the static (family, n) pairs
    f_sel = f_fam[..., jnp.asarray(fam_pos), jnp.asarray(n_idx)]  # (..., M)

    m_f = jnp.asarray(table.ms.astype(np.float32))
    n_f = jnp.asarray(table.ns.astype(np.float32))
    omega_mn = m_f * omega_phi[..., None] + n_f * omega_r[..., None]
    # omega^l with possibly negative omega (l is a static integer per mode)
    w2 = omega_mn * omega_mn
    w3 = w2 * omega_mn
    w4 = w2 * w2
    ls = jnp.asarray(table.ls)
    w8 = w4 * w4
    pw = jnp.where(
        ls == 2, w2,
        jnp.where(ls == 3, w3,
                  jnp.where(ls == 4, w4,
                            jnp.where(ls == 5, w4 * omega_mn,
                                      jnp.where(ls == 6, w4 * w2,
                                                jnp.where(ls == 7, w4 * w3,
                                                          jnp.where(ls == 8, w8,
                                                                    jnp.where(ls == 9, w8 * omega_mn,
                                                                              w8 * w2))))))),
    )

    a = pw * f_sel
    re = jnp.asarray(c_re, jnp.float32) * a
    im = jnp.asarray(c_im, jnp.float32) * a
    # downstream (spline fits, FD/TD kernels) runs f64; values carry f32
    # accuracy (~1e-6 relative), orders below the 1e-4 mismatch gate
    dt = jnp.asarray(p).dtype
    re = re.astype(dt)
    im = im.astype(dt)
    if tail:
        from .tail import tail_factor

        t_re, t_im = tail_factor(table.ls, omega_mn.astype(dt), r0=tail_r0)
        re, im = re * t_re - im * t_im, re * t_im + im * t_re
    if factorized:
        from .rho import factorized_correction

        c_re2, c_im2 = factorized_correction(
            table.ls, table.ms, jnp.asarray(p).astype(dt),
            jnp.asarray(e).astype(dt), omega_mn.astype(dt),
        )
        re, im = re * c_re2 - im * c_im2, re * c_im2 + im * c_re2
    if rwz:
        # strong-field modulus calibration from the in-repo RWZ solver
        # (models.rwz_calibration); calibrated against tail+factorized,
        # so it only composes meaningfully on top of them
        if not (tail and factorized):
            raise ValueError("rwz=True requires tail=True, factorized=True")
        from .amplitude_backends import u_of_pe
        from .rho import _x_of_mode
        from .rwz_calibration import rwz_correction, rwz_ecc_residual

        x_mn = _x_of_mode(omega_mn.astype(dt), table.ms)
        b = rwz_correction(table.ls, table.ms, x_mn)
        # genuinely eccentric strong-field residual beyond the
        # circular-equivalent prescription (eccentric-source RWZ solver):
        # complex — |R| corrects the modulus, arg R the per-mode phase
        r_re, r_im = rwz_ecc_residual(
            table.ls, table.ms, table.ns,
            u_of_pe(jnp.asarray(p).astype(dt), jnp.asarray(e).astype(dt)),
            jnp.asarray(e).astype(dt),
        )
        c_re, c_im = b * r_re, b * r_im
        re, im = re * c_re - im * c_im, re * c_im + im * c_re
    return re, im


def full_fidelity_amplitudes(
    p: jax.Array, e: jax.Array, table: ModeTable
) -> tuple[jax.Array, jax.Array]:
    """`mode_amplitudes` at the repo's highest physics rung (tail +
    factorized resummation + RWZ strong-field calibration incl. the
    eccentric residual).  Drop-in ``source=`` for the data-driven
    backends (`amplitude_backends.build_amplitude_grid` /
    `fit_roman_network`), so the shipped Interp2D / ROMAN tables carry
    the solver-calibrated relativistic content — the counterpart of the
    reference's Teukolsky-data-backed Interp2DAmplitude/RomanAmplitude
    (reference FD notebook cell 2)."""
    return mode_amplitudes(p, e, table, tail=True, factorized=True, rwz=True)


class NewtonianAmplitude:
    """OO facade pinning the reference amplitude-module call contract.

    ``amp(p, e, specific_modes=[(l, m, n)]) -> {(l,m,n): complex array}``
    (reference notebook cells 5/19). Negative-m requests are served via the
    equatorial symmetry A_{l,-m,-n} = (-1)^l conj(A_{l,m,n}).
    """

    def __init__(self, **kwargs):
        del kwargs  # max_init_len / use_gpu knobs are irrelevant under jit

    def __call__(self, p, e, specific_modes=None, n_max: int = 30):
        p = jnp.asarray(p)
        e = jnp.asarray(e)
        if specific_modes is None:
            table = default_mode_table(n_max)
            re, im = mode_amplitudes(p, e, table)
            return {
                (int(l), int(m), int(n)): np.asarray(re[..., i]) + 1j * np.asarray(im[..., i])
                for i, (l, m, n) in enumerate(zip(table.ls, table.ms, table.ns))
            }
        out = {}
        req = []
        flips = []
        for l, m, n in specific_modes:
            if m < 0:
                req.append((l, -m, -n))
                flips.append((-1.0) ** l)
            else:
                req.append((l, m, n))
                flips.append(None)
        table = ModeTable(
            np.array([r[0] for r in req]),
            np.array([r[1] for r in req]),
            np.array([r[2] for r in req]),
        )
        re, im = mode_amplitudes(p, e, table)
        for i, (lmn, flip) in enumerate(zip(specific_modes, flips)):
            a = np.asarray(re[..., i]) + 1j * np.asarray(im[..., i])
            out[lmn] = flip * np.conj(a) if flip is not None else a
        return out


__all__ = ["ModeTable", "default_mode_table", "mode_amplitudes", "NewtonianAmplitude"]
