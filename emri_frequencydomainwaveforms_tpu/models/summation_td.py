"""Time-domain interpolated mode summation.

Replaces the reference engine's CUDA ``InterpolatedModeSum`` (contract pinned
at reference notebook cell 2 and ``emri_pe.py:107-121``: spline the sparse
amplitude/phase knots, upsample to the dense ``dt`` grid, and sum
``h(t) = sum_lmn A_lmn(t) (-2)Y_lm e^{-i(m Phi_phi + n Phi_r)}`` including
the (-m, -n) equatorial partners; kwargs ``pad_output``/``odd_len``).

Design:
* one pair of phase splines (Phi_phi, Phi_r) serves every mode — per-mode
  phases are linear combinations ``m*Phi_phi + n*Phi_r`` formed on the dense
  grid, so the spline work is O(2) not O(modes);
* the dense-grid segment lookup (searchsorted over trajectory knots) is done
  once and shared by every spline evaluation;
* the mode axis is a `lax.scan` accumulating (h_plus, h_cross) — memory stays
  O(grid), not O(modes x grid), and XLA fuses each iteration into a handful
  of elementwise passes; all arithmetic is real f64 pairs (a choice made
  for the accelerator this package was first built for, which had no
  complex128, and f64 sincos emulated in software: ROADMAP Design items 2
  and 3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.cubic_spline import fit_cubic_spline, spline_eval_at_segments, _segment_index
from .amplitude import ModeTable
from .modeselect import SelectedModes


def td_mode_sum(
    t_knots: jax.Array,  # (K,) seconds, strictly increasing (padded tail ok)
    phi_phi_knots: jax.Array,  # (K,)
    phi_r_knots: jax.Array,  # (K,)
    a_re_knots: jax.Array,  # (K, M) amplitudes at knots for candidate table
    a_im_knots: jax.Array,  # (K, M)
    table: ModeTable,
    sel: SelectedModes,
    y_plus: tuple[jax.Array, jax.Array],  # (M,) re/im of Y_{l, m}
    y_minus: tuple[jax.Array, jax.Array],  # (M,) re/im of Y_{l, -m}
    t_grid: jax.Array,  # (N,) dense output times
    t_end: jax.Array,  # scalar: waveform zero after this time (plunge)
) -> tuple[jax.Array, jax.Array]:
    """Dense TD waveform -> (h_plus, h_cross), each (N,).

    Modes are the compacted ``sel.idx`` subset of ``table``; the -m partner of
    every m>0 mode is added via A_{l,-m,-n} = (-1)^l conj(A_{lmn}); for m=0
    modes the (0, -n) partner likewise (amplitudes tabulated for n>=1).
    """
    m_arr = jnp.asarray(table.ms.astype(np.float64))
    n_arr = jnp.asarray(table.ns.astype(np.float64))
    sigma_arr = jnp.asarray(((-1.0) ** table.ls).astype(np.float64))

    # shared segment lookup + phase evaluation
    seg = _segment_index(t_knots, t_grid)
    # not-a-knot to match the FD kernel's splines exactly (shared Legendre-
    # transform consistency; natural BC also distorts the edge chirp rate)
    sp_pp = fit_cubic_spline(t_knots, phi_phi_knots, bc="not-a-knot")
    sp_pr = fit_cubic_spline(t_knots, phi_r_knots, bc="not-a-knot")
    phi_phi_g = spline_eval_at_segments(sp_pp, seg, t_grid)
    phi_r_g = spline_eval_at_segments(sp_pr, seg, t_grid)
    live = (t_grid <= t_end).astype(t_grid.dtype)

    # amplitude splines for all candidate modes, then gather the selected set
    # gather the selected modes BEFORE the (K-sequential) spline fits
    sp_ar = fit_cubic_spline(t_knots, jnp.take(a_re_knots, sel.idx, axis=1).T, bc="not-a-knot")
    sp_ai = fit_cubic_spline(t_knots, jnp.take(a_im_knots, sel.idx, axis=1).T, bc="not-a-knot")

    ar_c = sp_ar.c  # (k_max, K-1, 4)
    ai_c = sp_ai.c
    m_sel = jnp.take(m_arr, sel.idx)
    n_sel = jnp.take(n_arr, sel.idx)
    sig_sel = jnp.take(sigma_arr, sel.idx)
    ypr = jnp.take(y_plus[0], sel.idx)
    ypi = jnp.take(y_plus[1], sel.idx)
    ymr = jnp.take(y_minus[0], sel.idx)
    ymi = jnp.take(y_minus[1], sel.idx)

    f32 = jnp.float32
    two_pi = 2.0 * jnp.pi
    live32 = live.astype(f32)

    def body(carry, mode):
        hp, hc = carry
        ar_ci, ai_ci, m_i, n_i, sg, ypr_i, ypi_i, ymr_i, ymi_i, w_i = mode
        # f64 phase combination (mul/add), then mod-2pi -> f32 sincos
        phase = m_i * phi_phi_g + n_i * phi_r_g
        phase32 = (phase - two_pi * jnp.round(phase * (1.0 / two_pi))).astype(f32)
        c = jnp.cos(phase32)
        s = jnp.sin(phase32)
        from ..ops.cubic_spline import CubicSplineCoeffs

        ar = spline_eval_at_segments(CubicSplineCoeffs(t_knots, ar_ci), seg, t_grid).astype(f32)
        ai = spline_eval_at_segments(CubicSplineCoeffs(t_knots, ai_ci), seg, t_grid).astype(f32)
        ypr_i, ypi_i = ypr_i.astype(f32), ypi_i.astype(f32)
        ymr_i, ymi_i = ymr_i.astype(f32), ymi_i.astype(f32)
        sg32 = sg.astype(f32)
        # direct term A Y_+ e^{-i phase}
        u = ar * ypr_i - ai * ypi_i
        v = ar * ypi_i + ai * ypr_i
        # partner term sigma conj(A) Y_- e^{+i phase}
        up = ar * ymr_i + ai * ymi_i
        vp = ar * ymi_i - ai * ymr_i
        hp_i = u * c + v * s + sg32 * (up * c - vp * s)
        hx_i = v * c - u * s + sg32 * (vp * c + up * s)
        w = w_i.astype(f32) * live32
        # h = h_+ - i h_x  =>  h_+ = Re h, h_x = -Im h
        return (hp + w * hp_i, hc - w * hx_i), None

    (hp, hc), _ = jax.lax.scan(
        body,
        (jnp.zeros(t_grid.shape, f32), jnp.zeros(t_grid.shape, f32)),
        (ar_c, ai_c, m_sel, n_sel, sig_sel, ypr, ypi, ymr, ymi, sel.mask),
    )
    return hp.astype(t_grid.dtype), hc.astype(t_grid.dtype)


__all__ = ["td_mode_sum", "direct_mode_sum", "DirectModeSum"]


def direct_mode_sum(
    t_knots,
    phi_phi_knots,
    phi_r_knots,
    a_re_knots,
    a_im_knots,
    table,
    sel,
    y_plus,
    y_minus,
    n_live,
):
    """Brute-force mode sum AT the trajectory knots (validation tool).

    Reference ``few.summation.directmodesum.DirectModeSum`` parity (notebook
    cell 2): no interpolation — the waveform evaluated exactly at the sparse
    trajectory samples. Returns (h_plus, h_cross) of knot length (padded
    region carries the frozen final value; mask with ``n_live``).
    """
    t_end = t_knots[jnp.maximum(n_live - 1, 0)]
    return td_mode_sum(
        t_knots, phi_phi_knots, phi_r_knots, a_re_knots, a_im_knots,
        table, sel, y_plus, y_minus, t_knots, t_end,
    )


class DirectModeSum:
    """OO facade for the reference's direct summation module."""

    def __init__(self, **kwargs):
        del kwargs

    def __call__(self, pro, table):
        return direct_mode_sum(
            pro.t_knots, pro.phi_phi, pro.phi_r, pro.a_re, pro.a_im,
            table, pro.sel, pro.y_plus, pro.y_minus, pro.n_live,
        )
