"""Frequency-domain stationary-phase mode summation — the framework's core.

Replaces the reference engine's CUDA FD summation kernel (``output_type="fd"``,
the contribution of arXiv:2307.12585; behavior pinned at reference
``emri_pe.py:86-105, 237-247, 349`` — arbitrary ``f_arr``, ``mask_positive``,
default odd ``fftshift(fftfreq(N, dt))`` grid — with the per-mode math spec in
``Tutorial_FD_construction_single_mode.ipynb`` cells 22-26: inversion of
t(f), SPA amplitude ``~ 1/sqrt(fdot)`` with the Bessel-K(1/3) turnover
correction).

Math (convention ``htilde(f) = int h(t) e^{-2 pi i f t} dt``, matching
``fft(h) * dt``): the TD waveform is the mode-pair sum

  h(t) = sum_i [ A_i(t) Y^+_i e^{-i Phi_i(t)}
                 + sigma_i conj(A_i)(t) Y^-_i e^{+i Phi_i(t)} ],

with Phi_i = m Phi_phi + n Phi_r increasing, sigma = (-1)^l,
Y^+ = -2Y_{lm}(th, ph), Y^- = -2Y_{l,-m}(th, ph). The partner term has a
stationary point at positive f where Phi_i'(t*) = 2 pi f:

  C_i(f) = conj(A_i)(t*) F_i(t*) e^{i(Phi_i(t*) - 2 pi f t*)},

with the uniform SPA factor (asymptotically e^{i pi/4}/sqrt(fdot))

  F = (2/sqrt(3)) (fdot/|fddot|) K_{1/3}(i w) e^{i w},
  w = -2 pi fdot^3 / (3 fddot^2).

BOTH the f<0 branch (from the direct term, via
``htilde(-f) = conj(sum_i C_i(f) conj(Y^+_i))``) and both polarization
channels are linear in the same core C_i(f):

  htilde(+f)        = sum_i C_i(f) (sigma_i Y^-_i)
  htilde(-f)        = conj( sum_i C_i(f) conj(Y^+_i) )
  htilde_plus(f>0)  = sum_i C_i(f) (sigma Y^- + conj(Y^+))/2
  htilde_cross(f>0) = sum_i C_i(f) i (sigma Y^- - conj(Y^+))/2

so the kernel evaluates C_i once per (mode, bin) and accumulates two
weighted outputs — one pass serves scalar-h, [h+, hx], and both signs.

Consistency is the accuracy-critical design decision: the per-mode frequency
is defined as the EXACT derivative of the per-mode phase spline,
``f_i(t) = Phi_i'(t)/(2 pi)`` (piecewise quadratic), not an independently
fitted spline. The TD kernel interpolates the same phase spline, so the FD
phase Psi(f) = Phi(t*) - 2 pi f t* is the exact Legendre transform of the TD
phase — stationarity holds to machine precision at the spline level and the
residual error is pure SPA truncation (O(1/w)), not spline cross-talk.
(An earlier implementation with separate f(t) splines showed oscillating
~0.05 rad phase residuals vs fft(TD) from exactly this inconsistency.)
It is also cheaper: t*(f) is a quadratic root per bin (3 cheap Newton steps,
derivative-consistent), fdot/fddot fall out of the same coefficients.

Design:
* per-mode phase splines are LINEAR COMBINATIONS of two shared splines
  (Phi_phi, Phi_r): coefficients combine as ``m*c_phi + n*c_r`` — no
  per-mode fits;
* the mode axis is a `lax.scan` accumulating 4 real (Nf,) outputs — O(grid)
  memory; bins outside a mode's [f_start, f_end] range or failing the
  monotonicity mask contribute exactly 0;
* all real arithmetic, MIXED precision: the phase path (segment solve, Phi
  Horner, Psi = Phi - 2 pi f t*) stays f64, then Psi is reduced mod 2 pi and
  the transcendental-heavy tail (sin/cos, Bessel, amplitude assembly) runs
  in f32. f32 noise enters only the ~1e-7-level amplitude/phase-mod, orders
  below the 1e-4 mismatch gate;
* the per-bin segment lookup exploits that ``f_pos`` is sorted: knot edges
  are positioned in the bin grid once per mode (K log Nf) and broadcast by a
  scatter+cumsum, instead of Nf independent binary searches (Nf log K
  serial gathers).

The real (re, im) pairs, the f64/f32 split, the hi/lo f32 pairs of
`_split_hi_lo` and the gather-free level-1 tables were shaped by the
accelerator this package was first built for, which had no complex128,
emulated f64 and slow random gathers. On the GPU each must earn its place
by measurement: ROADMAP Design items 2 and 3 and Speed item 4.

Scope: the general kernel (`fd_mode_sum`) evaluates each mode's first
INCREASING monotone run in its main scan slot and — with
``turnover_slots > 0`` — the first DECREASING run (post-turnover branch of
plunging harmonics) in extra slots, traversing nodes in reverse time with
the conjugated Bessel factor; the two branches' K_{1/3} factors sum to the
Airy caustic behavior at the fold (validated against brute-force
oscillatory integrals of a synthetic quadratic fold in
``tests/test_turnover.py``). With ``negative_slots > 0`` it also covers
NEGATIVE-frequency ranges (f_mn(t) < 0), whose radiation at +|f| comes
from the DIRECT term: under U = -Phi that term obeys this same kernel
with negated phase coefficients, conj-flipped amplitudes, and conjugated
weight pairs (validated against the golden scipy pipeline on the
mirrored phase).

The banded uniform kernel (`fd_mode_sum_uniform`) supports the SAME
turnover/negative content (round 3): the generalized level-1 machinery
evaluates arbitrary oriented knot windows, and extra slots run in a
second scan with their own (narrow) window budget so dead slots on
non-plunging batches cost ~extra_band_runs/band_runs of a main slot.
Accuracy note for plunging sources: within ~1 run of a frequency FOLD
(fdot -> 0 at the band end / branch junction) the uniform-in-f node grid
under-resolves the Airy region, leaving percent-level errors in those
bins vs the general kernel's t-space nodes (whole-band rel-L2 ~7e-3 on a
plunging source, ~2e-7 in the chirp regime). This is within the SPA's
own validity limit there — the FD/TD mismatch of plunging sources is
~1e-2 for BOTH kernels (SPA truncation at the fold dominates), so the
banded production path is physics-complete to the accuracy the
construction itself supports.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.bessel import kve_one_third_imag
from ..ops.cubic_spline import fit_cubic_spline, spline_eval
from .amplitude import ModeTable
from .modeselect import SelectedModes

_TWO_OVER_SQRT3 = 2.0 / math.sqrt(3.0)
_TWO_PI = 2.0 * math.pi
# name scope of the banded kernel's dense pass (main and extra slots): a
# profiler trace attributes device time to it by this name
DENSE_PASS_SCOPE = "fd_dense_pass"


class FDKernelInputs(NamedTuple):
    """Precomputed shared trajectory splines + per-mode data for the scan."""

    t_knots: jax.Array  # (K,)
    c_phi_phi: jax.Array  # (K-1, 4) spline coeffs of Phi_phi(t)
    c_phi_r: jax.Array
    f_phi_knots: jax.Array  # (K,) Phi_phi'(t_k)/(2 pi) — derivative-consistent
    f_r_knots: jax.Array
    ar_c: jax.Array  # (k_max, K-1, 4) selected amplitude splines (re)
    ai_c: jax.Array
    m_sel: jax.Array  # (k_max,) float m
    n_sel: jax.Array
    w1_re: jax.Array  # (k_max,) weight for output 1
    w1_im: jax.Array
    w2_re: jax.Array
    w2_im: jax.Array
    mode_live: jax.Array  # (k_max,) selection mask * validity mask
    n_live: jax.Array  # scalar int: live knot count
    n_eff: jax.Array  # (k_max,) int32: per-mode usable knot count (band
    # truncated at the first non-monotone segment, e.g. near plunge)
    # --- monotone-run windows for the turnover-capable general kernel ---
    # first INCREASING run of f_i(t) (knot window, inclusive): equals
    # [0, n_eff-1] for modes chirping up from the start; starts later for
    # modes that dip first. inc_live folds in sel.mask + a >=3-segment
    # length requirement.
    inc_lo: jax.Array  # (k_max,) int32
    inc_hi: jax.Array
    inc_live: jax.Array
    # first DECREASING run (the post-turnover branch near plunge, or the
    # pre-minimum branch of dipping modes)
    dec_lo: jax.Array
    dec_hi: jax.Array
    dec_live: jax.Array
    power: jax.Array  # (k_max,) selection power (ranks turnover slots)
    # --- NEGATIVE-frequency branch windows (direct-term radiation) ---
    # ranges where f_mn(t) < 0 radiate through the DIRECT term; under the
    # substitution U = -Phi they obey the partner-term kernel verbatim with
    # (m, n) -> (-m, -n), conj-flipped amplitudes, and the neg weight pairs
    # below (first increasing run of g = -f where g > 0)
    neg_lo: jax.Array
    neg_hi: jax.Array
    neg_live: jax.Array
    w1n_re: jax.Array  # neg-branch output weights (zeros when not provided)
    w1n_im: jax.Array
    w2n_re: jax.Array
    w2n_im: jax.Array


def prepare_fd_inputs(
    t_knots: jax.Array,
    n_live: jax.Array,
    phi_phi_knots: jax.Array,
    phi_r_knots: jax.Array,
    a_re_knots: jax.Array,  # (K, M)
    a_im_knots: jax.Array,
    table: ModeTable,
    sel: SelectedModes,
    w1: tuple[jax.Array, jax.Array],  # per-CANDIDATE-mode weights (M,) re/im
    w2: tuple[jax.Array, jax.Array],
    w1n: tuple[jax.Array, jax.Array] | None = None,  # negative-branch weights
    w2n: tuple[jax.Array, jax.Array] | None = None,
) -> FDKernelInputs:
    """Fit shared splines and compact per-mode arrays for `fd_mode_sum`."""
    # not-a-knot: a natural BC would force Phi'' = 0 at the ends, i.e. a
    # zero chirp rate at t=0 — the SPA envelope 1/sqrt(fdot) then diverges
    # at the band start (observed as a spurious peak in the first segment)
    sp_pp = fit_cubic_spline(t_knots, phi_phi_knots, bc="not-a-knot")
    sp_pr = fit_cubic_spline(t_knots, phi_r_knots, bc="not-a-knot")
    # gather the SELECTED modes before fitting: the tridiagonal solve is
    # sequential in K, so fitting all ~500 candidates to then keep k_max
    # wastes ~8x of the prologue's serial critical path
    a_re_sel = jnp.take(a_re_knots, sel.idx, axis=1)  # (K, k_max)
    a_im_sel = jnp.take(a_im_knots, sel.idx, axis=1)
    sp_ar = fit_cubic_spline(t_knots, a_re_sel.T, bc="not-a-knot")  # (k_max, K-1, 4)
    sp_ai = fit_cubic_spline(t_knots, a_im_sel.T, bc="not-a-knot")

    # knot frequencies from the phase-spline derivative (exact consistency)
    f_phi_knots = spline_eval(sp_pp, t_knots, deriv=1) / _TWO_PI
    f_r_knots = spline_eval(sp_pr, t_knots, deriv=1) / _TWO_PI

    m_arr = jnp.asarray(table.ms.astype(np.float64))
    n_arr = jnp.asarray(table.ns.astype(np.float64))
    m_sel = jnp.take(m_arr, sel.idx)
    n_sel = jnp.take(n_arr, sel.idx)

    # Per-mode monotonicity handling: rather than discarding a mode whose
    # frequency evolution turns over anywhere (near plunge the phase-spline
    # derivative wiggles in the last segments, which would kill EVERY mode
    # of an exactly-plunging source), truncate each mode's usable band at
    # its first non-monotone live segment. Harmonics non-monotone from the
    # start (strong negative-n near plunge) are still masked out.
    k = t_knots.shape[0]
    f_knots_all = m_sel[:, None] * f_phi_knots[None, :] + n_sel[:, None] * f_r_knots[None, :]
    seg_idx = jnp.arange(k - 1)
    live_seg = (seg_idx < (n_live - 1))[None, :]
    df = jnp.diff(f_knots_all, axis=1)
    bad = (df <= 0.0) & live_seg
    any_bad = jnp.any(bad, axis=1)
    first_bad = jnp.argmax(bad, axis=1)  # index of first bad segment
    n_eff = jnp.where(any_bad, first_bad + 1, n_live).astype(jnp.int32)
    positive = f_knots_all[:, 0] > 0.0
    enough = n_eff >= 4
    mode_live = sel.mask * (positive & enough).astype(t_knots.dtype)

    # monotone-run windows (turnover-capable general kernel): the first
    # increasing and first decreasing runs of the live knot frequencies.
    # EMRI harmonics have at most one physical turnover; wiggle runs
    # shorter than 3 segments are rejected by the length requirement.
    def _first_run(ok):
        any_ok = jnp.any(ok, axis=1)
        start = jnp.argmax(ok, axis=1)
        stop_mask = (~ok) & (seg_idx[None, :] >= start[:, None])
        stop = jnp.where(
            jnp.any(stop_mask, axis=1), jnp.argmax(stop_mask, axis=1), k - 1
        )
        ok_len = any_ok & ((stop - start) >= 3)
        return start.astype(jnp.int32), stop.astype(jnp.int32), ok_len

    # restrict runs to f > 0: the C_i(f) formula evaluates the PARTNER term
    # at stationary points with Phi' = 2 pi f > 0; negative-frequency ranges
    # obey the direct-term formula (A, Y^+, opposite phase sign) and are out
    # of scope here, as in the single-branch kernel
    pos_seg = (f_knots_all[:, :-1] > 0.0) & (f_knots_all[:, 1:] > 0.0)
    inc_lo, inc_hi, inc_ok = _first_run((df > 0.0) & live_seg & pos_seg)
    dec_lo, dec_hi, dec_ok = _first_run((df < 0.0) & live_seg & pos_seg)
    inc_live = sel.mask * inc_ok.astype(t_knots.dtype)
    dec_live = sel.mask * dec_ok.astype(t_knots.dtype)

    # negative-frequency branch: increasing runs of g = -f where g > 0
    neg_seg = (f_knots_all[:, :-1] < 0.0) & (f_knots_all[:, 1:] < 0.0)
    neg_lo, neg_hi, neg_ok = _first_run((df < 0.0) & live_seg & neg_seg)
    neg_live = sel.mask * neg_ok.astype(t_knots.dtype)

    return FDKernelInputs(
        t_knots=t_knots,
        c_phi_phi=sp_pp.c,
        c_phi_r=sp_pr.c,
        f_phi_knots=f_phi_knots,
        f_r_knots=f_r_knots,
        ar_c=sp_ar.c,  # already the selected subset (gathered before fit)
        ai_c=sp_ai.c,
        m_sel=m_sel,
        n_sel=n_sel,
        w1_re=jnp.take(w1[0], sel.idx),
        w1_im=jnp.take(w1[1], sel.idx),
        w2_re=jnp.take(w2[0], sel.idx),
        w2_im=jnp.take(w2[1], sel.idx),
        mode_live=mode_live,
        n_live=n_live,
        n_eff=n_eff,
        inc_lo=inc_lo,
        inc_hi=inc_hi,
        inc_live=inc_live,
        dec_lo=dec_lo,
        dec_hi=dec_hi,
        dec_live=dec_live,
        power=sel.power,
        neg_lo=neg_lo,
        neg_hi=neg_hi,
        neg_live=neg_live if w1n is not None else jnp.zeros_like(neg_live),
        w1n_re=jnp.take(w1n[0], sel.idx) if w1n is not None else jnp.zeros_like(m_sel),
        w1n_im=jnp.take(w1n[1], sel.idx) if w1n is not None else jnp.zeros_like(m_sel),
        w2n_re=jnp.take(w2n[0], sel.idx) if w2n is not None else jnp.zeros_like(m_sel),
        w2n_im=jnp.take(w2n[1], sel.idx) if w2n is not None else jnp.zeros_like(m_sel),
    )


def fd_mode_sum(
    inp: FDKernelInputs,
    f_pos: jax.Array,
    nodes_per_segment: int = 32,
    turnover_slots: int = 0,
    negative_slots: int = 0,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Accumulate sum_i C_i(f) * W1_i and * W2_i over the selected modes.

    ``turnover_slots``: static budget of extra scan slots evaluating the
    DECREASING monotone branch of modes whose f_i(t) turns over (plunging
    sources; reference construction evaluates every monotone branch with
    the uniform Bessel correction — the K_{1/3} factor of the two branches
    sums to the Airy fold behavior near fdot = 0). Slots are assigned to
    the highest-power turnover modes; 0 keeps the single-branch cost.

    ``negative_slots``: static budget for NEGATIVE-frequency ranges
    (f_mn(t) < 0), which radiate at +|f| through the DIRECT term. Under
    U = -Phi the direct term matches the partner-term kernel exactly with
    negated phase coefficients, conj-flipped amplitudes, and the
    w1n/w2n weight pairs (prepare_fd_inputs must receive w1n/w2n).

    Two-level evaluation (a reshaping of the reference's per-bin CUDA
    loop):

    **Level 1 — compression (f64, ~(K-1)*S nodes per mode).** Nodes are
    placed uniformly in t inside each trajectory spline segment, where
    everything is available in closed form WITHOUT root-finding:
    f = Phi'(t)/(2 pi), Psi = Phi - 2 pi f t, dPsi/df = -2 pi t (exact
    stationarity), the SPA/Bessel factor, and the complex envelope
    E = conj(A) F W. Per f-interval between nodes we build a cubic HERMITE
    representation of Psi (values + exact derivatives at both ends; the
    ~20-rad in-interval phase swing is cast to f32 after a mod-2pi shift of
    the constant term) and a linear POLAR representation of E — signed
    modulus + continuous phase (`_polar_envelope`), the phase added to Psi
    in the dense pass.

    **Level 2 — dense evaluation (f32).** Each output bin locates its node
    interval (scatter+cumsum over the sorted grid, no per-bin binary
    search), gathers 4+4 f32 coefficients, evaluates a Horner cubic + one
    sin/cos pair, and accumulates. Only one f64 gather+subtract survives
    per bin (the interval-local offset f - f_n, which must not lose the
    ~1e-9 Hz bin spacing against ~1e-3 Hz absolute frequencies).

    Interpolation error budget: node spacing df_n ~ band/((K-1) S) ~ 1e-7 Hz
    gives |d4Psi/df4| df_n^4 / 384 ~ 1e-12 rad mid-band; the f32 phase tail
    contributes ~1e-6 rad. Both are orders below the 1e-4 mismatch gate.

    Args:
      f_pos: (Nf,) strictly positive output frequencies, sorted ascending
        (any spacing — full fftshift grids and downsampled f_arr alike).

    Returns:
      (o1_re, o1_im, o2_re, o2_im), each (Nf,).
    """
    t_knots = inp.t_knots
    k = t_knots.shape[0]
    n_live = inp.n_live
    s_nodes = nodes_per_segment
    n_nodes = (k - 1) * s_nodes

    nf = f_pos.shape[0]
    f32 = jnp.float32

    # static node layout: segment index + fractional position per node
    seg_of_node = np.repeat(np.arange(k - 1), s_nodes)
    frac_of_node = np.tile(np.arange(s_nodes) / s_nodes, k - 1)
    seg_of_node_j = jnp.asarray(seg_of_node)
    frac_of_node_j = jnp.asarray(frac_of_node)
    h_all = jnp.diff(t_knots)  # (K-1,)
    dx_node = frac_of_node_j * jnp.take(h_all, seg_of_node_j)  # (N_nodes,)
    t_node = jnp.take(t_knots, seg_of_node_j) + dx_node
    node_idx = jnp.arange(n_nodes)

    def body(carry, mode):
        o1r, o1i, o2r, o2i = carry
        (cphi_m, ar_ci, ai_ci, w1r, w1i, w2r, w2i, live_i, k_lo_i, k_hi_i, dirn_i) = mode

        # ===== Level 1: per-node closed-form evaluation (f64) =====
        cn = jnp.take(cphi_m, seg_of_node_j, axis=0)  # (N_nodes, 4)
        c0, c1, c2, c3 = cn[..., 0], cn[..., 1], cn[..., 2], cn[..., 3]
        dxn = dx_node
        f_n = (c1 + dxn * (2.0 * c2 + 3.0 * c3 * dxn)) / _TWO_PI
        phi_n = c0 + dxn * (c1 + dxn * (c2 + dxn * c3))
        psi_n = phi_n - _TWO_PI * f_n * t_node
        fdot_n = (2.0 * c2 + 6.0 * c3 * dxn) / _TWO_PI
        fddot_n = (6.0 * c3) / _TWO_PI

        dxn32 = dxn.astype(f32)
        arn = jnp.take(ar_ci, seg_of_node_j, axis=0).astype(f32)
        ain = jnp.take(ai_ci, seg_of_node_j, axis=0).astype(f32)
        a_re = arn[..., 0] + dxn32 * (arn[..., 1] + dxn32 * (arn[..., 2] + dxn32 * arn[..., 3]))
        a_im = ain[..., 0] + dxn32 * (ain[..., 1] + dxn32 * (ain[..., 2] + dxn32 * ain[..., 3]))

        # uniform SPA factor in the overflow-free f32 form
        #   F = C(w) / sqrt(|fdot|),  C(w) = K_{1/3}(i w) e^{i w} sqrt(2|w|/pi)
        # (algebraically equal to (2/sqrt3)(|fdot|/|fddot|) K13 e^w; C ->
        # e^{i pi/4} away from turnover, -> 0 as w -> 0). w is formed in f64
        # (fdot^3 ~ 1e-33 underflows f32) then cast; the Bessel evaluation
        # and envelope assembly run in f32. On a DECREASING
        # branch (dirn < 0) the true argument has the opposite sign and the
        # factor is the complex conjugate (asymptote e^{-i pi/4}): evaluate
        # at -|w| and flip the imaginary part.
        fdot_s = jnp.maximum(jnp.abs(fdot_n), 1e-300)
        w_arg = -_TWO_PI * fdot_s**3 / (3.0 * jnp.maximum(fddot_n * fddot_n, 1e-300))
        w32 = jnp.clip(w_arg, -1e12, -1e-30).astype(f32)  # floor only guards
    # log(0); the ascending series is accurate to w -> 0 (fold interior)
        k_re, k_im = kve_one_third_imag(w32)
        k_im = k_im * dirn_i.astype(f32)
        corr = jnp.sqrt(2.0 * jnp.abs(w32) * f32(1.0 / math.pi))
        inv_sqrt_fdot = jax.lax.rsqrt(jnp.maximum(fdot_s.astype(f32), f32(1e-37)))
        cr = k_re * corr * inv_sqrt_fdot
        ci = k_im * corr * inv_sqrt_fdot
        # envelope E = conj(A) * F  (f32)
        e_re = a_re * cr + a_im * ci
        e_im = a_re * ci - a_im * cr

        # Node ordering must ascend in f: on a decreasing branch traverse
        # the nodes in reverse time. (jnp.where on the flipped arrays — a
        # cheap elementwise select, shared across the scan body.)
        rev = dirn_i < 0

        def orient(x):
            return jnp.where(rev, x[::-1], x)

        f_n = orient(f_n)
        psi_n = orient(psi_n)
        t_node_o = orient(t_node)
        e_re = orient(e_re)
        e_im = orient(e_im)

        # knot window -> node window (in oriented index space)
        lo_n = k_lo_i * s_nodes
        hi_n = k_hi_i * s_nodes
        lo_o = jnp.where(rev, (n_nodes - 1) - hi_n, lo_n)
        hi_o = jnp.where(rev, (n_nodes - 1) - lo_n, hi_n)

        # strictly-increasing node frequency array: true values inside the
        # window, linear ramps outside (coefficients of out-of-window
        # intervals are garbage; their bins are masked by in_range). The
        # node AT each window edge keeps its true value so the edge
        # intervals get genuine Hermite coefficients.
        f_lo_val = f_n[jnp.clip(lo_o, 0, n_nodes - 1)]
        f_hi_val = f_n[jnp.clip(hi_o, 0, n_nodes - 1)]
        step = jnp.maximum(jnp.abs(f_hi_val), 1.0)
        below = node_idx < lo_o
        above = node_idx > hi_o
        f_node_s = jnp.where(
            below,
            f_lo_val - (lo_o - node_idx).astype(f_n.dtype) * step,
            jnp.where(
                above,
                f_hi_val + (node_idx - hi_o).astype(f_n.dtype) * step,
                f_n,
            ),
        )
        f_start, f_end = f_lo_val, f_hi_val
        t_node_l = t_node_o

        # per-interval coefficients (interval i: node i -> node i+1)
        f_lo = f_node_s
        df_n = jnp.diff(f_node_s, append=f_node_s[-1:] + 1.0)
        inv_df = 1.0 / jnp.where(jnp.abs(df_n) > 0, df_n, 1.0)
        psi_hi = jnp.roll(psi_n, -1)
        t_hi = jnp.roll(t_node_l, -1)
        # Hermite in xi = (f - f_lo)/df: values psi_lo/psi_hi, exact
        # derivatives dPsi/df = -2 pi t  ->  d/dxi = -2 pi t * df
        d_lo = -_TWO_PI * t_node_l * df_n
        d_hi = -_TWO_PI * t_hi * df_n
        dpsi = psi_hi - psi_n
        p0_full = psi_n  # unreduced; the f64 dense Horner reduces at the end
        p1 = d_lo
        p2 = 3.0 * dpsi - 2.0 * d_lo - d_hi
        p3 = -2.0 * dpsi + d_lo + d_hi
        # envelope: linear in xi, in POLAR form (modulus + continuous
        # phase; see _level1_uniform_tables — both kernels must interpolate
        # the same quantities for kernel equivalence, and polar resolves
        # the omega-dependent rwz/tail envelope rotation that Cartesian
        # chord interpolation cannot). Anchored at the window-start node so
        # garbage diffs from out-of-window nodes (inf envelopes where the
        # extrapolated fdot underflows) cannot shift in-window phases.
        e_abs, e_phs = _polar_envelope(e_re, e_im, anchor=lo_o)
        ea0_32 = e_abs.astype(f32)
        dea_32 = (jnp.roll(e_abs, -1) - e_abs).astype(f32)
        ep0_32 = e_phs.astype(f32)
        dep_32 = (jnp.roll(e_phs, -1) - e_phs).astype(f32)
        # sanitize the dense-pass tables (parity with the banded kernel's
        # pc/ec sanitize): a non-finite IN-WINDOW node — e.g. an envelope
        # that overflows f32 where fdot underflows at a near-fold node —
        # would otherwise poison its two adjacent
        # intervals through the node diffs, and the where-mask cannot null
        # NaN afterwards
        ea0_32, dea_32, ep0_32, dep_32 = (
            jnp.where(jnp.isfinite(v), v, 0.0)
            for v in (ea0_32, dea_32, ep0_32, dep_32)
        )

        in_range = (f_pos >= f_start) & (f_pos <= f_end)

        # ===== Level 2: dense evaluation (f32 + one f64 gather/sub) =====
        # interval index via node positions in the sorted bin grid
        edge_pos = jnp.searchsorted(f_pos, f_node_s, side="left")  # (N_nodes,)
        counts = jnp.zeros((nf + 1,), jnp.int32).at[edge_pos].add(1, mode="drop")
        j = jnp.cumsum(counts[:nf]) - 1
        j = jnp.clip(j, 0, n_nodes - 2)

        f_lo_b = jnp.take(f_lo, j)  # f64 gather — bin offset needs f64
        xi64 = (f_pos - f_lo_b) * jnp.take(inv_df, j)  # f64: xi rounding
        xi = xi64.astype(f32)       # multiplies ~300-rad phase slopes

        # f64 phase Horner: the Hermite coefficients reach hundreds of
        # radians (p1 = -2 pi t df_n), so an f32 Horner carries ~1e-4 rad
        # of rounding — the driver of the banded/general cross-check noise
        # before the f64 Horner. This kernel runs on gate/Fisher-sized
        # subsets (the banded kernel is the scored hot path, with its own
        # exact integer-cycle fix); mod-reduce once at the end, sin/cos
        # stay f32.
        psi64 = jnp.take(p0_full, j) + xi64 * (
            jnp.take(p1, j) + xi64 * (jnp.take(p2, j) + xi64 * jnp.take(p3, j))
        )
        psi32 = (psi64 - _TWO_PI * jnp.round(psi64 * (1.0 / _TWO_PI))).astype(f32)
        amp_b = jnp.take(ea0_32, j) + xi * jnp.take(dea_32, j)
        psi32 = psi32 + jnp.take(ep0_32, j) + xi * jnp.take(dep_32, j)
        c_re = amp_b * jnp.cos(psi32)
        c_im = amp_b * jnp.sin(psi32)

        keep = in_range & (live_i > 0)
        c_re = jnp.where(keep, c_re, 0.0).astype(f32)
        c_im = jnp.where(keep, c_im, 0.0).astype(f32)

        w1r32, w1i32 = w1r.astype(f32), w1i.astype(f32)
        w2r32, w2i32 = w2r.astype(f32), w2i.astype(f32)
        o1r = o1r + c_re * w1r32 - c_im * w1i32
        o1i = o1i + c_re * w1i32 + c_im * w1r32
        o2r = o2r + c_re * w2r32 - c_im * w2i32
        o2i = o2i + c_re * w2i32 + c_im * w2r32
        return (o1r, o1i, o2r, o2i), None

    zero = jnp.zeros(f_pos.shape, f32)
    # per-mode spline coefficients as linear combos of the shared splines
    cphi_all = (
        inp.m_sel[:, None, None] * inp.c_phi_phi[None]
        + inp.n_sel[:, None, None] * inp.c_phi_r[None]
    )
    k_max = cphi_all.shape[0]
    slots = [
        cphi_all,
        inp.ar_c,
        inp.ai_c,
        inp.w1_re,
        inp.w1_im,
        inp.w2_re,
        inp.w2_im,
        inp.inc_live,
        inp.inc_lo,
        inp.inc_hi,
        jnp.ones((k_max,), jnp.int32),  # dirn = +1
    ]
    if turnover_slots > 0:
        # assign extra slots to the highest-power modes with a decreasing run
        score = inp.dec_live * (inp.power + 1e-300)
        _, pick = jax.lax.top_k(score, min(turnover_slots, k_max))
        picked_live = jnp.take(inp.dec_live, pick)
        extra = [
            jnp.take(cphi_all, pick, axis=0),
            jnp.take(inp.ar_c, pick, axis=0),
            jnp.take(inp.ai_c, pick, axis=0),
            jnp.take(inp.w1_re, pick),
            jnp.take(inp.w1_im, pick),
            jnp.take(inp.w2_re, pick),
            jnp.take(inp.w2_im, pick),
            picked_live,
            jnp.take(inp.dec_lo, pick),
            jnp.take(inp.dec_hi, pick),
            -jnp.ones((pick.shape[0],), jnp.int32),  # dirn = -1
        ]
        slots = [jnp.concatenate([a, b], axis=0) for a, b in zip(slots, extra)]
    if negative_slots > 0:
        score_n = inp.neg_live * (inp.power + 1e-300)
        _, pick_n = jax.lax.top_k(score_n, min(negative_slots, k_max))
        extra_n = [
            -jnp.take(cphi_all, pick_n, axis=0),  # U = -Phi
            jnp.take(inp.ar_c, pick_n, axis=0),
            -jnp.take(inp.ai_c, pick_n, axis=0),  # A in place of conj(A)
            jnp.take(inp.w1n_re, pick_n),
            jnp.take(inp.w1n_im, pick_n),
            jnp.take(inp.w2n_re, pick_n),
            jnp.take(inp.w2n_im, pick_n),
            jnp.take(inp.neg_live, pick_n),
            jnp.take(inp.neg_lo, pick_n),
            jnp.take(inp.neg_hi, pick_n),
            jnp.ones((pick_n.shape[0],), jnp.int32),  # g = -f increases
        ]
        slots = [jnp.concatenate([a, b], axis=0) for a, b in zip(slots, extra_n)]
    (o1r, o1i, o2r, o2i), _ = jax.lax.scan(
        body, (zero, zero, zero, zero), tuple(slots)
    )
    dt_out = f_pos.dtype
    return o1r.astype(dt_out), o1i.astype(dt_out), o2r.astype(dt_out), o2i.astype(dt_out)


def fd_mode_sum_uniform(
    inp: FDKernelInputs,
    f0: float,
    df: float,
    nf: int,
    *,
    bins_per_run: int = 64,
    band_runs: int | None = None,
    band_offsets: jax.Array | None = None,
    turnover_slots: int = 0,
    negative_slots: int = 0,
    turnover_pick: jax.Array | None = None,
    negative_pick: jax.Array | None = None,
    band_offsets_extra: jax.Array | None = None,
    extra_band_runs: int | None = None,
    scan_unroll: int = 1,
    slot_unroll: bool | None = None,
    out_dtype=None,
    _return_padded: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Gather-minimal FD summation for UNIFORM output grids f = f0 + i*df.

    The performance-critical variant (the default fftshift grid and the
    ``freq[::k]`` downsampled likelihood grids are uniform). Exploits two
    structural facts: random gathers are far slower than arithmetic, and a
    mode's band covers only a few percent of the full grid. Design:

    * **Band windowing**: per mode, interpolation nodes are placed only over
      its band — every ``bins_per_run``-th bin starting at the run containing
      f_start, ``band_runs`` runs (static budget; content above the window is
      masked out, budget defaults to the full grid when unspecified).
    * **Node evaluation** (f64): each node's trajectory segment comes from a
      short hand-rolled binary search over the K knot frequencies; 3 Newton
      steps solve the quadratic Phi'(t) = 2 pi f_node; Psi, dPsi/df = -2 pi t,
      and the f32 envelope E = conj(A) K13-corr/sqrt(fdot) are evaluated in
      closed form. ~20 gathers per NODE (not per bin).
    * **Gather-free dense pass** (f32): within a run, bins evaluate a phase
      Hermite cubic (exact node derivatives) and a Catmull-Rom POLAR
      envelope (signed modulus + phase folded into the sin/cos arg) by
      broadcasting per-run coefficients over a (band_runs, bins_per_run)
      workspace — reshapes, no gathers, one sin/cos pair per bin-mode.
    * **Dynamic-window accumulation**: each mode's (band_runs*bins_per_run)
      contribution is added into the padded output at its run offset via a
      contiguous dynamic read-modify-write.

    band_offsets: optional per-mode window start runs, (k_max,) int32.
    CRITICAL under vmap: per-lane (traced, batched) window offsets force XLA
    to lower the read-modify-write as a scatter; offsets
    passed here UNBATCHED (vmap in_axes=None / closed-over constants, e.g.
    computed once per walker batch from a representative source with a
    margin) keep it a true dynamic slice. When omitted, offsets are derived
    per lane from each slot's oriented band start (correct but slow under
    vmap).

    turnover_slots / negative_slots: static budgets of extra scan slots for
    the DECREASING monotone branch (post-turnover plunge content) and the
    NEGATIVE-frequency direct-term branch, with the same semantics as
    `fd_mode_sum`. ``turnover_pick`` / ``negative_pick`` optionally pin the
    slot -> mode assignment (shared across a vmapped batch, computed from a
    representative source); default is a per-lane power-ranked top-k.
    ``band_offsets_extra`` supplies shared window offsets for the extra
    slots (turnover slots first), (turnover_slots + negative_slots,) int32.

    Returns (o1_re, o1_im, o2_re, o2_im), each (nf,), f64.
    """
    t_knots = inp.t_knots
    f32 = jnp.float32
    r = bins_per_run
    g_total = -(-nf // r)  # runs covering the grid
    g_band = g_total if band_runs is None else min(band_runs, g_total)
    n_nodes = g_band + 1
    pad_len = (g_total + g_band) * r  # accumulation space incl. window slack

    run_df = r * df
    f_pos_dtype = t_knots.dtype

    cphi_all = (
        inp.m_sel[:, None, None] * inp.c_phi_phi[None]
        + inp.n_sel[:, None, None] * inp.c_phi_r[None]
    )
    f_knots_all = (
        inp.m_sel[:, None] * inp.f_phi_knots[None, :] + inp.n_sel[:, None] * inp.f_r_knots[None, :]
    )
    k_max = cphi_all.shape[0]

    # ---- extra-slot assembly (turnover + negative branches) ----
    # Extra slots run in a SEPARATE scan with their own (typically much
    # narrower) window budget: fold/negative bands cover a sliver of the
    # grid, so dead or narrow extra slots cost ~extra_band_runs/band_runs
    # of a main slot instead of doubling the scan length.
    extras = []  # list of (cphi, ar, ai, fk, klo, khi, dirn, live, w[4])
    if turnover_slots > 0:
        if turnover_pick is not None:
            pick = jnp.asarray(turnover_pick, jnp.int32)
        else:
            score = inp.dec_live * (inp.power + 1e-300)
            _, pick = jax.lax.top_k(score, min(turnover_slots, k_max))
        extras.append((
            jnp.take(cphi_all, pick, axis=0),
            jnp.take(inp.ar_c, pick, axis=0),
            jnp.take(inp.ai_c, pick, axis=0),
            jnp.take(f_knots_all, pick, axis=0),
            jnp.take(inp.dec_lo, pick),
            jnp.take(inp.dec_hi, pick),
            -jnp.ones((pick.shape[0],), jnp.int32),
            jnp.take(inp.dec_live, pick),
            [jnp.take(w, pick) for w in (inp.w1_re, inp.w1_im, inp.w2_re, inp.w2_im)],
        ))
    if negative_slots > 0:
        if negative_pick is not None:
            pick_n = jnp.asarray(negative_pick, jnp.int32)
        else:
            score_n = inp.neg_live * (inp.power + 1e-300)
            _, pick_n = jax.lax.top_k(score_n, min(negative_slots, k_max))
        # U = -Phi: negated phase coefficients, A in place of conj(A)
        # (a_im sign flip), mirrored knot frequencies, neg weight pairs
        extras.append((
            -jnp.take(cphi_all, pick_n, axis=0),
            jnp.take(inp.ar_c, pick_n, axis=0),
            -jnp.take(inp.ai_c, pick_n, axis=0),
            -jnp.take(f_knots_all, pick_n, axis=0),
            jnp.take(inp.neg_lo, pick_n),
            jnp.take(inp.neg_hi, pick_n),
            jnp.ones((pick_n.shape[0],), jnp.int32),
            jnp.take(inp.neg_live, pick_n),
            [jnp.take(w, pick_n) for w in (inp.w1n_re, inp.w1n_im, inp.w2n_re, inp.w2n_im)],
        ))

    # ---- main-slot window offsets ----
    f_start_main = jnp.take_along_axis(
        f_knots_all, inp.inc_lo[:, None].astype(jnp.int32), axis=1
    )[:, 0]
    if band_offsets is None:
        g0_main = jnp.floor((f_start_main - f0) / run_df).astype(jnp.int32)
    else:
        g0_main = jnp.asarray(band_offsets, jnp.int32)
    g0_main = jnp.clip(g0_main, 0, g_total)

    # slot_unroll: accumulate the main slots in an UNROLLED python loop
    # instead of a lax.scan. The scan threads the 4 x pad_len f32
    # accumulators through its carry, and XLA materializes carry copies at
    # the loop boundary, which cost more than the dense flops themselves
    # when it was first profiled. Unrolled, each slot's
    # read-modify-write aliases the previous buffer and the whole chain
    # fuses (the extras path below always ran unrolled for this reason).
    # Default: on for banded windows (small per-slot workspace), off for
    # whole-grid windows where k_max copies of the (g_total, r) dense
    # workspace would bloat the program.
    if slot_unroll is None:
        slot_unroll = band_runs is not None and g_band < g_total

    # exact integer-cycle phase needs the bins on a power-of-two lattice
    cyc = (r & (r - 1)) == 0

    def scan_slots(carry, cphi_s, ar_s, ai_s, fk_s, klo_s, khi_s, dirn_s,
                   live_s, w_s, g0_s, g_band_s, n_nodes_s):
        pc, nc, ec, f_start_all, f_end_all = _level1_uniform_tables(
            cphi_s, ar_s, ai_s, fk_s, g0_s, klo_s, khi_s, dirn_s,
            t_knots, f0, df, r, n_nodes_s, run_df, cycle_split=cyc,
        )

        xs = (pc, nc, ec, f_start_all, f_end_all, w_s[0], w_s[1], w_s[2],
              w_s[3], live_s, g0_s)

        with jax.named_scope(DENSE_PASS_SCOPE):
            if slot_unroll:
                for s in range(pc.shape[0]):
                    carry, _ = _dense_slot_accumulate(
                        carry, tuple(x[s] for x in xs),
                        f0, df, r, run_df, g_band_s, f_pos_dtype,
                    )
                return carry

            def body(carry, mode):
                return _dense_slot_accumulate(
                    carry, mode, f0, df, r, run_df, g_band_s, f_pos_dtype
                )

            carry, _ = jax.lax.scan(body, carry, xs, unroll=scan_unroll)
            return carry

    zero = jnp.zeros((pad_len,), f32)
    carry = scan_slots(
        (zero, zero, zero, zero),
        cphi_all, inp.ar_c, inp.ai_c, f_knots_all,
        inp.inc_lo, inp.inc_hi, jnp.ones((k_max,), jnp.int32),
        inp.inc_live, [inp.w1_re, inp.w1_im, inp.w2_re, inp.w2_im],
        g0_main, g_band, n_nodes,
    )

    if extras:
        g_band_x = g_band if extra_band_runs is None else min(extra_band_runs, g_total)
        ex = [jnp.concatenate([e[i] for e in extras], axis=0) for i in range(8)]
        ex_w = [
            jnp.concatenate([e[8][i] for e in extras]) for i in range(4)
        ]
        f_start_x = jnp.take_along_axis(
            ex[3],
            jnp.where(ex[6] > 0, ex[4], ex[5])[:, None].astype(jnp.int32),
            axis=1,
        )[:, 0]
        if band_offsets_extra is not None:
            g0_x = jnp.asarray(band_offsets_extra, jnp.int32)
        else:
            g0_x = jnp.floor((f_start_x - f0) / run_df).astype(jnp.int32)
        g0_x = jnp.clip(g0_x, 0, g_total)
        # few extra slots: UNROLLED accumulation (a second lax.scan forces
        # copies of the 4 x pad_len f32 carry between loop bodies; the
        # unrolled form fuses)
        pc_x, nc_x, ec_x, fst_x, fen_x = _level1_uniform_tables(
            ex[0], ex[1], ex[2], ex[3], g0_x, ex[4], ex[5], ex[6],
            t_knots, f0, df, r, g_band_x + 1, run_df, cycle_split=cyc,
        )
        with jax.named_scope(DENSE_PASS_SCOPE):
            for s in range(pc_x.shape[0]):
                carry, _ = _dense_slot_accumulate(
                    carry,
                    (pc_x[s], nc_x[s], ec_x[s], fst_x[s], fen_x[s],
                     ex_w[0][s], ex_w[1][s], ex_w[2][s], ex_w[3][s],
                     ex[7][s], g0_x[s]),
                    f0, df, r, run_df, g_band_x, f_pos_dtype,
                )

    o1r, o1i, o2r, o2i = carry
    if _return_padded:
        return o1r, o1i, o2r, o2i
    # the accumulators are f32 (the dense pass's native precision); the
    # default f64 cast is interface convenience — out_dtype=float32 skips
    # it on hot paths (halves the output write traffic, no information)
    dt_out = t_knots.dtype if out_dtype is None else out_dtype
    return (
        o1r[:nf].astype(dt_out),
        o1i[:nf].astype(dt_out),
        o2r[:nf].astype(dt_out),
        o2i[:nf].astype(dt_out),
    )


def _dense_slot_accumulate(carry, mode, f0, df, r, run_df, g_band_s, f_pos_dtype):
    """One slot's gather-free dense pass + windowed accumulation.

    The shared body of the banded kernel's mode scan and the unrolled
    extra-slot path: evaluate the phase Hermite + envelope cubic over the
    (g_band_s, r) workspace, mask to the slot's band, and read-modify-write
    the window into the padded accumulators via contiguous dynamic slices.
    """
    f32 = jnp.float32
    o1r, o1i, o2r, o2i = carry
    (pc_i, nc_i, ec_i, f_start, f_end, w1r, w1i, w2r, w2i, live_i, g0) = mode

    xi = ((jnp.arange(r, dtype=f32)) * f32(1.0 / r))[None, :]  # (1, r)
    p0, p1, p2, p3 = pc_i[:, 0:1], pc_i[:, 1:2], pc_i[:, 2:3], pc_i[:, 3:4]
    psi_d = p0 + xi * (p1 + xi * (p2 + xi * p3))
    if nc_i is not None:
        # exact integer-cycle phase (see _level1_uniform_tables): bins sit
        # at xi = b/r with r a power of two, so the 2pi-cycle part of the
        # cubic reduces mod 2pi in EXACT int32 arithmetic —
        #   cyc(b) = (n1 b r^2 + n2 b^2 r + n3 b^3) mod r^3
        # evaluated as a Horner chain with a bitmask reduction after every
        # step ((a b) mod M = ((a mod M) b) mod M; two's-complement AND
        # with M-1 = r^3-1 IS mod M). Worst-case intermediates with
        # |n| < 2^15, r <= 128: < 2^30 — no overflow.
        mask = r * r * r - 1
        b = jnp.arange(r, dtype=jnp.int32)[None, :]  # (1, r)
        n1, n2, n3 = nc_i[:, 0:1], nc_i[:, 1:2], nc_i[:, 2:3]
        u = jnp.bitwise_and(b * n3, mask)
        u = jnp.bitwise_and(r * n2 + u, mask)
        u = jnp.bitwise_and(b * u, mask)
        u = jnp.bitwise_and(r * r * n1 + u, mask)
        u = jnp.bitwise_and(b * u, mask)  # in [0, r^3)
        psi_d = psi_d + u.astype(f32) * f32(_TWO_PI / (r * r * r))
    # polar envelope (see _level1_uniform_tables): slots 0:4 = modulus
    # cubic, slots 4:8 = envelope-phase cubic, folded into the sin/cos
    # argument — same one transcendental pair per bin-mode as before
    ea0, ea1, ea2, ea3 = ec_i[:, 0:1], ec_i[:, 1:2], ec_i[:, 2:3], ec_i[:, 3:4]
    ep0, ep1, ep2, ep3 = ec_i[:, 4:5], ec_i[:, 5:6], ec_i[:, 6:7], ec_i[:, 7:8]
    amp_d = ea0 + xi * (ea1 + xi * (ea2 + xi * ea3))
    psi_d = psi_d + ep0 + xi * (ep1 + xi * (ep2 + xi * ep3))
    c_re = amp_d * jnp.cos(psi_d)
    c_im = amp_d * jnp.sin(psi_d)

    # band mask in int32 bin-index space instead of an f64 per-bin
    # frequency grid (g_band, r) with two f64 compares. The band limits are
    # per-slot SCALARS, so fold them to bin indices once (f64, 2 scalars)
    # and compare the shared int32 local-index grid against them — exact:
    # bin i is kept iff i >= ceil((f_start - f0)/df) and i <= floor(...).
    i_lo = jnp.ceil((f_start - f0) / df).astype(jnp.int32) - g0 * r
    i_hi = jnp.floor((f_end - f0) / df).astype(jnp.int32) - g0 * r
    i_lo = jnp.where(live_i > 0, i_lo, jnp.iinfo(jnp.int32).max)
    idx_local = (
        jnp.arange(g_band_s, dtype=jnp.int32)[:, None] * r
        + jnp.arange(r, dtype=jnp.int32)[None, :]
    )
    keep = (idx_local >= i_lo) & (idx_local <= i_hi)
    # where-mask (not multiply): masked lanes can hold NaN/inf from
    # extrapolated or non-monotone (masked-out) modes, 0 * NaN = NaN
    c_re = jnp.where(keep, c_re, 0.0).astype(f32)
    c_im = jnp.where(keep, c_im, 0.0).astype(f32)

    w1r32, w1i32 = w1r.astype(f32), w1i.astype(f32)
    w2r32, w2i32 = w2r.astype(f32), w2i.astype(f32)
    v1r = (c_re * w1r32 - c_im * w1i32).reshape(-1)
    v1i = (c_re * w1i32 + c_im * w1r32).reshape(-1)
    v2r = (c_re * w2r32 - c_im * w2i32).reshape(-1)
    v2i = (c_re * w2i32 + c_im * w2r32).reshape(-1)

    off = g0 * r
    win = g_band_s * r

    def rmw(acc, contrib):
        cur = jax.lax.dynamic_slice(acc, (off,), (win,))
        return jax.lax.dynamic_update_slice(acc, cur + contrib, (off,))

    return (rmw(o1r, v1r), rmw(o1i, v1i), rmw(o2r, v2r), rmw(o2i, v2i)), None


def _split_hi_lo(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """f64 -> (hi, lo) f32 pair with x == hi + lo to ~2^-48 relative.

    hi is rounded by an explicit `reduce_precision`, not by a convert
    round trip: XLA's GPU compiler may drop a f64 -> f32 -> f64 convert
    pair (excess precision is allowed by default), which left lo = 0 and
    cost the banded kernel a 7e-3 rel-L2 error on an H100.
    """
    hi = jax.lax.reduce_precision(x, exponent_bits=8, mantissa_bits=23)
    return hi.astype(jnp.float32), (x - hi).astype(jnp.float32)


def _polar_envelope(e_re, e_im, anchor=None):
    """Node-wise (SIGNED modulus, continuous phase) of a complex envelope.

    Write E_k = s_k e^{i phs_k} with s_k = +-|E_k| and phs continuous
    along the last (node) axis. Per-node steps of arg E are folded into
    (-pi/2, pi/2]; each discarded half-turn flips the SIGN of the modulus
    instead. This matters for (near-)real envelopes crossing zero — the
    flat-physics amplitudes exactly, the rwz stack's weakly-rotated ones
    approximately: there consecutive node phases jump by ~pi, and a
    2pi-centered unwrap must pick the sweep direction (+pi or -pi) by
    ulp-level rounding of the atan2 inputs — a DEVICE-DEPENDENT branch
    (it once made both FD kernels diverge between two backends at the
    bench config) that also draws the interpolated envelope through the
    flip at full modulus. The signed-modulus form crosses zero like the
    Cartesian representation (exact for real envelopes), keeps polar's
    resolution of smooth rotations (steps << pi/2 fold to themselves),
    and keeps phs BOUNDED by the physical rotation (no pi-per-flip
    accumulation), so f32 carries it to ~1e-6 rad.

    Non-finite diffs (garbage out-of-window nodes can carry inf/NaN
    envelopes) are zeroed so they cannot poison the cumulative sums, and
    the result is re-anchored at node ``anchor`` (default 0): the
    constant c = phs_a + pi par_a - raw_a — zero in exact arithmetic,
    arbitrary past zeroed garbage — is subtracted from phs, which
    restores s_k e^{i phs_k} = E_k exactly (mod 2pi) at every node
    connected to the anchor through finite diffs; for an in-window
    anchor that is the whole window.
    """
    pi_ = math.pi
    e_abs = jnp.sqrt(e_re * e_re + e_im * e_im)
    raw = jnp.arctan2(e_im, e_re)
    d = jnp.diff(raw, axis=-1)
    n = jnp.round(d * (1.0 / pi_))
    ok = jnp.isfinite(d)
    d = jnp.where(ok, d - n * pi_, 0.0)
    n = jnp.where(ok, n, 0.0)
    zero = jnp.zeros_like(raw[..., :1])
    phs = jnp.concatenate([zero, jnp.cumsum(d, axis=-1)], axis=-1)
    par = jnp.concatenate([zero, jnp.cumsum(n, axis=-1)], axis=-1)
    sign = 1.0 - 2.0 * jnp.mod(par, 2.0)
    idx_v = anchor if anchor is not None else 0
    idx = jnp.clip(idx_v, 0, raw.shape[-1] - 1)[..., None] * jnp.ones(
        raw.shape[:-1] + (1,), jnp.int32
    )
    raw_a = jnp.take_along_axis(raw, idx, axis=-1)
    phs_a = jnp.take_along_axis(phs, idx, axis=-1)
    par_a = jnp.take_along_axis(par, idx, axis=-1)
    # pi*par_a enters only mod 2pi; reduce the parity BEFORE multiplying
    # by pi (par_a mod 2 is exact in f32, pi*par_a at par_a ~ 1e3 is not)
    # so c — and with it every returned phase — stays rotation-sized
    c = jnp.where(
        jnp.isfinite(raw_a), phs_a + pi_ * jnp.mod(par_a, 2.0) - raw_a, 0.0
    )
    return sign * e_abs, phs - c


def _level1_uniform_tables(
    cphi_all,  # (S, K-1, 4) f64 per-slot phase spline coeffs (pre-transformed)
    ar_all,  # (S, K-1, 4) f64 amplitude-re spline coeffs
    ai_all,
    f_knots_all,  # (S, K) f64 knot frequencies (of the slot's phase, signed)
    g0_all,  # (S,) int32 window-start runs
    k_lo,  # (S,) int32 first knot of the slot's monotone window
    k_hi,  # (S,) int32 last knot (inclusive)
    dirn,  # (S,) +1 increasing-in-t branch, -1 decreasing (turnover)
    t_knots,  # (K,) f64
    f0: float,
    df: float,
    r: int,
    n_nodes: int,
    run_df: float,
    cycle_split: bool = False,
):
    """Gather-free level-1 node evaluation for ALL slots at once.

    A gather-free replacement for per-node binary search + table gathers:
    because the node grid is UNIFORM in f and the windowed knot
    frequencies are monotone, the node->segment assignment is a counting
    problem. We build the (node, boundary) compare matrix over the
    ORIENTED window (traversed ascending in f: forward in t on increasing
    branches, reverse on decreasing ones), difference it into an exact
    one-hot selector, and fetch every per-segment quantity with ONE matmul
    against the orientation-permuted segment table. f64 phase inputs ride
    the matmul as exact (hi, lo) f32 pairs: the selector rows are exactly
    one 1.0 and the HIGHEST-precision product is full f32 (exact for a
    one-hot selector on the GPU as on the CPU; a default-precision one may
    run in TF32), so selection is bit-exact and hi + lo reconstructs the
    f64 coefficient to double-float precision (ROADMAP Speed item 4 asks
    whether a plain f64 gather beats this on the GPU).

    Returns per-run f32 tables for the dense pass: phase Hermite pc
    (S, G, 4), integer 2pi-cycle counts nc (S, G, 3) int32 (or None, see
    below), envelope coefficients ec (S, G, 8), band limits f_start /
    f_end (S,) f64 (oriented: f_start < f_end always).

    ``cycle_split=True`` (the banded production path, round 5): the
    per-run phase coefficients p1..p3 reach hundreds of radians
    (p1 = -2 pi t* run_df ~ 400 rad at 1 yr x 64-bin runs), so a plain
    f32 dense Horner carries ~|p| * 2^-24 ~ 1e-4 rad of rounding — the
    measured source of the rwz banded/general disagreement before the
    split (gate at 1e-3). Since the dense pass evaluates at EXACT lattice points
    xi = b/r (b integer, r a power of two), each coefficient splits as
    p_i = q_i + 2 pi n_i with n_i = round(p_i / 2 pi) int32 and
    |q_i| <= pi: the integer part contributes
    2 pi (n1 b r^2 + n2 b^2 r + n3 b^3) / r^3 mod 2 pi — EXACT int32
    arithmetic in the dense pass — and the f32 polynomial keeps only
    O(1)-rad coefficients (~2e-7 rad rounding). pc holds the residuals
    q and nc the cycle counts. With ``cycle_split=False`` (runs of a
    length that is not a power of two) pc holds the raw f32 coefficients
    and nc is all zeros.
    """
    f32 = jnp.float32
    k = t_knots.shape[0]
    mk = cphi_all.shape[0]
    dt64 = t_knots.dtype

    inc = dirn[:, None] > 0
    # oriented band limits: ascending-f traversal starts at k_lo (inc) or
    # k_hi (dec)
    idx_start = jnp.where(dirn > 0, k_lo, k_hi)[:, None].astype(jnp.int32)
    idx_end = jnp.where(dirn > 0, k_hi, k_lo)[:, None].astype(jnp.int32)
    f_start = jnp.take_along_axis(f_knots_all, idx_start, axis=1)[:, 0]
    f_end = jnp.take_along_axis(f_knots_all, idx_end, axis=1)[:, 0]
    f_node = (
        f0
        + (g0_all.astype(dt64)[:, None] + jnp.arange(n_nodes, dtype=dt64)[None, :]) * run_df
    )  # (Mk, n_nodes)

    # --- segment assignment: one-hot from the monotone compare matrix ---
    # oriented interior boundaries b_j = f(oriented knot j+1), j+1 <=
    # win_len - 1, masked to a huge increasing ramp beyond the window so
    # count = min(count, win_len - 1); NaN boundaries (dead slots) compare
    # false -> segment 0 -> masked later
    win_len = (k_hi - k_lo).astype(jnp.int32)  # segments in window
    jj = jnp.arange(1, k - 1)  # oriented knot numbers 1..K-2
    idx_bnd = jnp.where(inc, k_lo[:, None] + jj[None, :], k_hi[:, None] - jj[None, :])
    # boundary gather + compare in f32 (an f64 gather moves twice the
    # bytes). Segment assignment only steers which
    # C2-continuous cubic the Newton solve starts from, so an f32-ulp tie
    # (~6e-8 relative, vs node spacing ~1e-4 of f) at worst seeds from the
    # neighboring segment, which the seed clip already tolerates.
    f_bnd = jnp.take_along_axis(
        f_knots_all.astype(f32), jnp.clip(idx_bnd, 0, k - 1).astype(jnp.int32), axis=1
    )
    bnd = jnp.where(
        jj[None, :] <= (win_len[:, None] - 1),
        f_bnd,
        f32(1e30) * (1.0 + jj[None, :].astype(f32)),
    )  # (Mk, K-2) f32
    a_cmp = (bnd[:, None, :] <= f_node[:, :, None].astype(f32)).astype(f32)  # (Mk, N, K-2)
    ones = jnp.ones((mk, n_nodes, 1), f32)
    zeros = jnp.zeros((mk, n_nodes, 1), f32)
    a_ext = jnp.concatenate([ones, a_cmp, zeros], axis=-1)  # (Mk, N, K)
    onehot = a_ext[..., :-1] - a_ext[..., 1:]  # (Mk, N, K-1) exact {0,1}

    # --- packed per-segment table: f64 pairs + f32 tail ---
    c_hi, c_lo = _split_hi_lo(cphi_all)  # (Mk, K-1, 4) each
    t_lo64 = t_knots[:-1]
    tl_hi, tl_lo = _split_hi_lo(t_lo64)  # (K-1,)
    h_seg32 = jnp.diff(t_knots).astype(f32)
    shared = jnp.broadcast_to(
        jnp.stack([tl_hi, tl_lo, h_seg32], axis=-1)[None], (mk, k - 1, 3)
    )
    f_lo32 = f_knots_all[:, :-1].astype(f32)
    f_hi32 = f_knots_all[:, 1:].astype(f32)
    tab = jnp.concatenate(
        [
            c_hi,  # 0:4
            c_lo,  # 4:8
            shared,  # 8:11  t_lo_hi, t_lo_lo, h_seg
            f_lo32[..., None],  # 11
            f_hi32[..., None],  # 12
            ar_all.astype(f32),  # 13:17
            ai_all.astype(f32),  # 17:21
        ],
        axis=-1,
    )  # (Mk, K-1, 21)
    # orientation permutation: oriented segment s -> actual segment
    # k_lo + s (inc) or k_hi - 1 - s (dec); one cheap (K-1)-row gather per
    # slot, NOT per node
    ss = jnp.arange(k - 1)
    seg_of_s = jnp.where(inc, k_lo[:, None] + ss[None, :], k_hi[:, None] - 1 - ss[None, :])
    tab = jnp.take_along_axis(
        tab, jnp.clip(seg_of_s, 0, k - 2).astype(jnp.int32)[:, :, None], axis=1
    )
    g = jax.lax.dot_general(
        onehot,
        tab,
        (((2,), (1,)), ((0,), (0,))),
        precision=jax.lax.Precision.HIGHEST,
    )  # (Mk, N, 21)

    c0 = g[..., 0].astype(dt64) + g[..., 4].astype(dt64)
    c1 = g[..., 1].astype(dt64) + g[..., 5].astype(dt64)
    c2 = g[..., 2].astype(dt64) + g[..., 6].astype(dt64)
    c3 = g[..., 3].astype(dt64) + g[..., 7].astype(dt64)
    t_lo = g[..., 8].astype(dt64) + g[..., 9].astype(dt64)
    h_seg = g[..., 10].astype(dt64)
    f_lo = g[..., 11].astype(dt64)
    f_hi = g[..., 12].astype(dt64)

    # --- Newton for dx: Phi'(dx) = 2 pi f_node (quadratic; 3 steps).
    # Nodes just outside the band (the first node sits <= f_start, the
    # last run's right node can sit > f_end) EXTRAPOLATE the edge
    # segment's phase cubic mildly instead of clamping to the segment:
    # clamped nodes would mislabel the edge Hermite intervals (values at
    # t_end tagged with a frequency above f_end), corrupting the last
    # in-band bins. Out-of-band bins themselves are masked. ---
    y = _TWO_PI * f_node
    denom = jnp.where(jnp.abs(f_hi - f_lo) > 0, f_hi - f_lo, 1.0)
    dx = jnp.clip((f_node - f_lo) / denom, -0.5, 1.5) * h_seg
    for _ in range(3):
        fp = c1 + dx * (2.0 * c2 + 3.0 * c3 * dx) - y
        fpp = 2.0 * c2 + 6.0 * c3 * dx
        fpp = jnp.where(jnp.abs(fpp) > 1e-300, fpp, 1e-300)
        dx = jnp.clip(dx - fp / fpp, -0.5 * h_seg, 1.5 * h_seg)
    t_star = t_lo + dx

    phi = c0 + dx * (c1 + dx * (c2 + dx * c3))
    psi = phi - y * t_star
    # envelope quantities use the IN-segment point: the extrapolated
    # quadratic Phi' can peak just past the band (fdot -> 0 blows up
    # 1/sqrt(fdot)); the O(run_df) envelope offset at the <=R edge bins
    # is benign while the phase must stay extrapolation-consistent.
    dx_env = jnp.clip(dx, 0.0, h_seg)
    # |fdot|: the chirp rate is negative on decreasing (dirn = -1) branches
    fdot = jnp.maximum(jnp.abs(2.0 * c2 + 6.0 * c3 * dx_env) / _TWO_PI, 1e-300)
    fddot = (6.0 * c3) / _TWO_PI

    dx32 = dx_env.astype(f32)
    a_re = g[..., 13] + dx32 * (g[..., 14] + dx32 * (g[..., 15] + dx32 * g[..., 16]))
    a_im = g[..., 17] + dx32 * (g[..., 18] + dx32 * (g[..., 19] + dx32 * g[..., 20]))
    w_arg = -_TWO_PI * fdot**3 / (3.0 * jnp.maximum(fddot * fddot, 1e-300))
    w32 = jnp.clip(w_arg, -1e12, -1e-30).astype(f32)  # floor only guards
    # log(0); the ascending series is accurate to w -> 0 (fold interior)
    k_re, k_im = kve_one_third_imag(w32)
    # decreasing branch: the true Bessel argument flips sign and the factor
    # is the complex conjugate (asymptote e^{-i pi/4}) — flip the imaginary
    # part (same convention as the general kernel's dirn handling)
    k_im = k_im * dirn[:, None].astype(f32)
    corr = jnp.sqrt(2.0 * jnp.abs(w32) * f32(1.0 / math.pi))
    inv_sq = jax.lax.rsqrt(jnp.maximum(fdot.astype(f32), f32(1e-37)))
    cr_f = k_re * corr * inv_sq
    ci_f = k_im * corr * inv_sq
    e_re = a_re * cr_f + a_im * ci_f
    e_im = a_re * ci_f - a_im * cr_f

    # --- anchored node quantities: every node also carries its value at
    # the band-CLAMPED point (dx_env); f_eff is the exact frequency there
    # (= f_node in band, = f_start / f_end for out-of-band nodes). Band-edge
    # intervals are then interpolated between EXACT in-band anchors instead
    # of extrapolated node values: extrapolating the last trajectory
    # segment's cubic past the band end mislabels the edge runs (the
    # extrapolated quadratic Phi' can bend back near plunge, where round 2
    # measured order-unity errors in the final runs of plunge-truncated
    # modes), while the anchored form touches the spline only inside its
    # domain of validity. ---
    f_eff = (c1 + dx_env * (2.0 * c2 + 3.0 * c3 * dx_env)) / _TWO_PI
    t_eff = t_lo + dx_env
    phi_eff = c0 + dx_env * (c1 + dx_env * (c2 + dx_env * c3))
    psi_eff = phi_eff - _TWO_PI * f_eff * t_eff

    # --- per-run phase coefficients (intervals g -> g+1), f64 -> f32 ---
    # plain Hermite on the raw nodes (interior intervals; also the sliver
    # fallback below)
    psi_lo, psi_hi = psi[:, :-1], psi[:, 1:]
    d_lo = -_TWO_PI * t_star[:, :-1] * run_df  # dPsi/dxi at left node
    d_hi = -_TWO_PI * t_star[:, 1:] * run_df
    dpsi = psi_hi - psi_lo
    p0_plain = psi_lo
    p1_plain = d_lo
    p2_plain = 3.0 * dpsi - 2.0 * d_lo - d_hi
    p3_plain = -2.0 * dpsi + d_lo + d_hi

    # anchored Hermite: cubic in u = (xi - xa)/(xb - xa) through the
    # clamped anchors, composed back into an xi-polynomial (the dense pass
    # stays unchanged). Interior intervals have xa = 0, xb = 1 and
    # reproduce the plain form. The f64 spine stops at the DIFFERENCES
    # (dpsi, q0 mod 2pi, anchors); the composition arithmetic runs in f32
    # (ROADMAP Design item 2). Residual f32 error: ~|alpha|^3-
    # amplified rounding ~2e-4 rad confined to the few edge intervals.
    xa = ((f_eff[:, :-1] - f_node[:, :-1]) / run_df).astype(f32)
    xb = ((f_eff[:, 1:] - f_node[:, :-1]) / run_df).astype(f32)
    span = xb - xa
    # slivers (band edge within span_min of a node) keep the plain Hermite:
    # the xi-composition would blow its coefficients up as 1/span^3, and
    # the plain form's extrapolation error is weighted by h01(u <= span) ~
    # 3 span^2 there — negligible at span < 1/8
    span_min = f32(0.125)
    anchored = span >= span_min
    span_safe = jnp.where(anchored, span, f32(1.0))
    psi_a = psi_eff[:, :-1]
    da = (-_TWO_PI * run_df) * t_eff[:, :-1]
    db = (-_TWO_PI * run_df) * t_eff[:, 1:]
    dpsi_a = (psi_eff[:, 1:] - psi_a).astype(f32)
    q0 = (psi_a - _TWO_PI * jnp.round(psi_a * (1.0 / _TWO_PI))).astype(f32)
    da32, db32 = da.astype(f32), db.astype(f32)
    q1 = span_safe * da32
    q2 = 3.0 * dpsi_a - span_safe * (2.0 * da32 + db32)
    q3 = -2.0 * dpsi_a + span_safe * (da32 + db32)
    beta = 1.0 / span_safe
    alpha = -xa * beta
    c0_anc = q0 + alpha * (q1 + alpha * (q2 + alpha * q3))
    c1_anc = beta * (q1 + alpha * (2.0 * q2 + 3.0 * alpha * q3))
    c2_anc = beta * beta * (q2 + 3.0 * alpha * q3)
    c3_anc = beta * beta * beta * q3
    two_pi32 = f32(_TWO_PI)
    c0_anc = c0_anc - two_pi32 * jnp.round(c0_anc * f32(1.0 / _TWO_PI))

    # interior intervals keep the plain Hermite with its f64-difference
    # precision (the f32 q-differences above carry ~7e-5 rad of rounding —
    # fine for the few edge intervals, not for the whole band)
    use_anc = anchored & ((xa > f32(1e-4)) | (xb < f32(1.0 - 1e-4)))
    p0_plain32 = (p0_plain - _TWO_PI * jnp.round(p0_plain * (1.0 / _TWO_PI))).astype(f32)
    p0c = jnp.where(use_anc, c0_anc, p0_plain32)
    if cycle_split:
        # exact integer-cycle split (see docstring). Plain intervals split
        # in f64 (residual exact to ~2e-7 rad); anchored edge intervals
        # split their f32 coefficients (no precision change — the anchored
        # composition is f32 by design, its ~2e-4 rad tail is confined to
        # the few band-edge intervals). Out-of-window garbage intervals
        # (the linear f-ramps) can hold enormous-but-finite values: zero
        # them (their bins are masked in the dense pass) so the int32
        # cycle counts never overflow.
        def split64(p):
            ok = jnp.isfinite(p) & (jnp.abs(p) < 2.0e5)
            n = jnp.where(ok, jnp.round(p * (1.0 / _TWO_PI)), 0.0)
            q = jnp.where(ok, p - _TWO_PI * n, 0.0)
            return q.astype(f32), n.astype(jnp.int32)

        def split32(c):
            ok = jnp.isfinite(c) & (jnp.abs(c) < f32(2.0e5))
            n = jnp.where(ok, jnp.round(c * f32(1.0 / _TWO_PI)), f32(0.0))
            q = jnp.where(ok, c - n * f32(_TWO_PI), f32(0.0))
            return q, n.astype(jnp.int32)

        q1p, n1p = split64(p1_plain)
        q2p, n2p = split64(p2_plain)
        q3p, n3p = split64(p3_plain)
        q1a, n1a = split32(c1_anc)
        q2a, n2a = split32(c2_anc)
        q3a, n3a = split32(c3_anc)
        p1c = jnp.where(use_anc, q1a, q1p)
        p2c = jnp.where(use_anc, q2a, q2p)
        p3c = jnp.where(use_anc, q3a, q3p)
        nc = jnp.stack(
            [
                jnp.where(use_anc, n1a, n1p),
                jnp.where(use_anc, n2a, n2p),
                jnp.where(use_anc, n3a, n3p),
            ],
            axis=-1,
        )  # (Mk, G, 3) int32
    else:
        p1c = jnp.where(use_anc, c1_anc, p1_plain.astype(f32))
        p2c = jnp.where(use_anc, c2_anc, p2_plain.astype(f32))
        p3c = jnp.where(use_anc, c3_anc, p3_plain.astype(f32))
        # zero cycle counts: the dense pass's integer chain reduces to an
        # exact +0 (keeps one code path / one scan signature)
        nc = jnp.zeros(p1c.shape + (3,), jnp.int32)

    # --- POLAR envelope (round 5): interpolate (|E|, arg E), not (Re, Im).
    # Under the omega-dependent rwz/tail amplitude rotations the complex
    # envelope ROTATES along each band; a Catmull-Rom of Re/Im resolves
    # that rotation as chord-vs-arc interpolation error — the measured
    # (deterministic, CPU-f64-confirmed) 6.4e-4 banded-vs-general residual
    # at the bench config. Modulus and continuous phase are slowly varying
    # real functions, so the same cubic resolves them to the flat-physics
    # level, and the phase rides into the dense pass's sin/cos argument
    # (no extra transcendental). The general kernel uses the identical
    # polar convention (kernel-equivalence requires both sides to
    # interpolate the same quantities).
    e_abs, e_phs = _polar_envelope(e_re, e_im)

    # Catmull-Rom envelope: cubic from values at g-1, g, g+1, g+2
    def cr_coeffs(v):
        vm = jnp.concatenate([v[:, :1], v[:, :-1]], axis=1)[:, :-1]
        v0 = v[:, :-1]
        v1 = v[:, 1:]
        vp = jnp.concatenate([v[:, 1:], v[:, -1:]], axis=1)[:, 1:]
        s0 = 0.5 * (v1 - vm)
        s1 = 0.5 * (vp - v0)
        return v0, s0, 3.0 * (v1 - v0) - 2.0 * s0 - s1, -2.0 * (v1 - v0) + s0 + s1

    er0, er1, er2, er3 = cr_coeffs(e_abs)
    ei0, ei1, ei2, ei3 = cr_coeffs(e_phs)

    # band-EDGE intervals: affine envelope between the exact anchors
    # E(xi) = E_a + (xi - xa) (E_b - E_a) / span (envelope node values are
    # already evaluated at the clamped points). Same sliver fallback and
    # edge tolerance as the phase selection.
    is_edge = use_anc
    xa32 = xa
    inv_span32 = beta

    def edge_affine(v):
        v0 = v[:, :-1]
        d = (v[:, 1:] - v0) * inv_span32
        return v0 - xa32 * d, d

    er0_l, er1_l = edge_affine(e_abs)
    ei0_l, ei1_l = edge_affine(e_phs)
    zero32 = jnp.zeros_like(er0_l)
    er0 = jnp.where(is_edge, er0_l, er0)
    er1 = jnp.where(is_edge, er1_l, er1)
    er2 = jnp.where(is_edge, zero32, er2)
    er3 = jnp.where(is_edge, zero32, er3)
    ei0 = jnp.where(is_edge, ei0_l, ei0)
    ei1 = jnp.where(is_edge, ei1_l, ei1)
    ei2 = jnp.where(is_edge, zero32, ei2)
    ei3 = jnp.where(is_edge, zero32, ei3)

    pc = jnp.stack([p0c, p1c, p2c, p3c], axis=-1)  # (Mk, G, 4)
    ec = jnp.stack([er0, er1, er2, er3, ei0, ei1, ei2, ei3], axis=-1)  # (Mk, G, 8)
    # sanitize: masked/garbage modes can carry NaN through the tables; the
    # dense kernel's keep-mask can't null NaN*0, so null them here
    pc = jnp.where(jnp.isfinite(pc), pc, 0.0)
    ec = jnp.where(jnp.isfinite(ec), ec, 0.0)
    return pc, nc, ec, f_start, f_end


__all__ = [
    "FDKernelInputs",
    "prepare_fd_inputs",
    "fd_mode_sum",
    "fd_mode_sum_uniform",
]
