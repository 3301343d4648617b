"""User-facing waveform generators (source frame + detector frame).

Pins the reference API surface:

* ``FastSchwarzschildEccentricFlux(M, mu, p0, e0, theta, phi, dist=, T=, dt=,
  eps=, mode_selection=, f_arr=, mask_positive=)`` — source-frame generator
  (reference notebook cells 3/26; ``emri_pe.py:86-121`` sum_kwargs
  ``output_type="fd"``, ``pad_output``, ``odd_len``).
* ``GenerateEMRIWaveform`` — detector-frame wrapper over 14 parameters
  ``(M, mu, a, p0, e0, x0, dist, qS, phiS, qK, phiK, Phi_phi0, Phi_theta0,
  Phi_r0)`` with distance scaling ``mu*MRSUN_SI/(dist*Gpc)`` (notebook cell
  23/26) and ``return_list`` -> [h+, hx] vs h+ - i hx (``emri_pe.py:86-121``).
* the generator exposes ``.frequency`` — the FD output grid — mirroring
  ``few_gen.waveform_generator.create_waveform.frequency``
  (``emri_pe.py:237-247``).

The jittable functional cores (`fd_waveform_core`, `td_waveform_core`) are
what production code (likelihoods, samplers) should call — they take traced
parameters, run trajectory -> amplitudes -> selection -> summation entirely
on device, and vmap over sources/walkers.

Detector-frame angle convention (documented, self-consistent; the upstream
engine's exact frame rotation is not independently checkable offline):
sky direction R = (sin qS cos phiS, ...), orbital angular momentum
L = (sin qK cos phiK, ...); the source-frame viewing angles are the
coordinates of the propagation direction -R in the source frame with z along
L and x along the projection of the SSB z-axis; the polarization rotation
2*psi maps the source-frame (e_Theta, e_Phi) basis onto the SSB sky basis.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.constants import Gpc, MRSUN_SI, MTSUN_SI, YRSID_SI
from ..utils.ylm import spin_weighted_ylm
from .amplitude import ModeTable, default_mode_table, mode_amplitudes
from .inspiral import schwarz_ecc_flux_inspiral
from .modeselect import SelectedModes, mode_power, select_modes, table_indices_for
from .summation_fd import fd_mode_sum, fd_mode_sum_uniform, prepare_fd_inputs
from .summation_td import td_mode_sum


class WaveformPrologue(NamedTuple):
    """Everything the summation kernels need, computed once per source."""

    t_knots: jax.Array
    n_live: jax.Array
    phi_phi: jax.Array
    phi_r: jax.Array
    a_re: jax.Array  # (K, M)
    a_im: jax.Array
    sel: SelectedModes
    y_plus: tuple[jax.Array, jax.Array]
    y_minus: tuple[jax.Array, jax.Array]
    t_end: jax.Array
    dist_factor: jax.Array


def waveform_prologue(
    mass_1,
    mass_2,
    p0,
    e0,
    theta,
    phi,
    dist,
    Phi_phi0,
    Phi_r0,
    *,
    t_years: float,
    table: ModeTable,
    k_max: int,
    eps,
    forced_idx: np.ndarray | None = None,
    max_steps: int = 512,
    flux: str = "pm",
    tail: bool = False,
    factorized: bool = False,
    rwz: bool = False,
    traj_method: str = "dp5",
) -> WaveformPrologue:
    """Trajectory + amplitudes + Ylm + mode selection (shared by TD/FD).

    ``flux``: trajectory dissipation model — "pm" (Peters-Mathews),
    "multipole" (l <= 4 mode-sum flux grid; see `models.flux`),
    "multipole_tail" (same, with the |T_lm|^2 wave-tail enhancement),
    "multipole_factorized" (tail + effective source + rho_lm resummation)
    or "multipole_rwz" (additionally the RWZ strong-field calibration —
    exact circular-limit per-mode fluxes from the in-repo solver).
    ``tail``: apply the factorized relativistic tail factor T_lm to every
    amplitude (`models.tail`; pair with flux="multipole_tail" to keep the
    dissipation energy-balanced with the emitted waveform).
    ``factorized``: apply the effective source and rho_lm/delta_lm residual
    resummation to every amplitude (`models.rho`; pair with
    flux="multipole_factorized").
    ``rwz``: additionally apply the strong-field modulus calibration from
    the in-repo first-principles RWZ solver (`models.rwz_calibration`) —
    circular-limit amplitude moduli become exact at every PN order; full
    amplitude fidelity = tail + factorized + rwz, paired with
    flux="multipole_rwz".
    ``traj_method``: "dp5" (adaptive stepper) or "quad" (parallel-in-time
    quadrature, `models.trajectory_quad` — see `schwarz_ecc_flux_inspiral`).
    """
    traj = schwarz_ecc_flux_inspiral(
        mass_1, mass_2, p0, e0, t_years=t_years, Phi_phi0=Phi_phi0, Phi_r0=Phi_r0,
        max_steps=max_steps, flux=flux, method=traj_method,
    )
    a_re, a_im = mode_amplitudes(
        traj.p, traj.e, table, tail=tail, factorized=factorized, rwz=rwz
    )  # (K, M)

    yp_re, yp_im = spin_weighted_ylm(table.ls, table.ms, theta, phi)
    ym_re, ym_im = spin_weighted_ylm(table.ls, -table.ms, theta, phi)

    live = (jnp.arange(traj.t.shape[0]) < traj.n).astype(traj.t.dtype)
    if forced_idx is not None:
        # explicit mode_selection list: keep exactly these modes
        k_sel = len(forced_idx)
        sel = SelectedModes(
            idx=jnp.asarray(forced_idx, jnp.int32),
            mask=jnp.ones((k_sel,), traj.t.dtype),
            power=jnp.zeros((k_sel,), traj.t.dtype),
        )
    else:
        power = mode_power(a_re, a_im, yp_re, yp_im, ym_re, ym_im, dt_weights=live)
        # order selected slots by band-start frequency: slot identity then
        # varies smoothly across a walker batch, so the banded FD kernel's
        # per-slot window offsets can be shared batch-wide (margins absorb
        # the drift) even when lanes select slightly different top-k sets
        from .geodesic import fundamental_frequencies_seconds

        om_phi0, om_r0 = fundamental_frequencies_seconds(traj.p[0], traj.e[0], mass_1)
        f_start_key = (
            jnp.asarray(table.ms.astype(np.float64)) * om_phi0
            + jnp.asarray(table.ns.astype(np.float64)) * om_r0
        ) / (2.0 * math.pi)
        sel = select_modes(power, k_max, eps, order_key=f_start_key)

    dist_factor = mass_2 * MRSUN_SI / (dist * Gpc)
    t_end = traj.t[jnp.maximum(traj.n - 1, 0)]
    return WaveformPrologue(
        t_knots=traj.t,
        n_live=traj.n,
        phi_phi=traj.Phi_phi,
        phi_r=traj.Phi_r,
        a_re=a_re,
        a_im=a_im,
        sel=sel,
        y_plus=(yp_re, yp_im),
        y_minus=(ym_re, ym_im),
        t_end=t_end,
        dist_factor=dist_factor,
    )


def _sigma(table: ModeTable) -> jax.Array:
    # equatorial partner symmetry A_{l,-m,-n} = (-1)^l conj(A_{lmn}) — the
    # standard planar-system relation, which holds for mass AND current
    # families (the current families' imaginary projection constants carry
    # the extra parity; validated mode-by-mode against the Thorne-4.8
    # brute force in tests/test_amplitude.py)
    return jnp.asarray(((-1.0) ** table.ls).astype(np.float64))


def fd_waveform_core(
    pro: WaveformPrologue,
    table: ModeTable,
    f_pos: jax.Array,
    channels: bool = True,
    uniform: tuple[float, float] | None = None,
    band_runs: int | None = None,
    bins_per_run: int = 64,
    band_offsets=None,
    turnover_slots: int = 0,
    negative_slots: int = 0,
    extra_band_runs: int | None = None,
    band_offsets_extra=None,
    scan_unroll: int = 1,
    slot_unroll: bool | None = None,
    out_f32: bool = False,
    nodes_per_segment: int = 32,
):
    """FD waveform on positive frequencies.

    channels=True: returns (hp_re, hp_im, hc_re, hc_im) — whitened-ready
    [h+, hx] spectra at f>0 (reality fixes f<0).
    channels=False: returns (pos_re, pos_im, negc_re, negc_im) where
    htilde(+f) = pos, htilde(-f) = conj(negc) — the scalar h = h+ - i hx
    on the full grid.

    uniform: static ``(f0, df)`` when ``f_pos[i] = f0 + i*df`` — routes to
    the gather-minimal banded kernel (`fd_mode_sum_uniform`), the fast path
    for default and ``[::k]``-downsampled grids. ``band_runs`` bounds each
    mode's frequency window (None = full grid, always safe);
    ``band_offsets`` (k_max,) shares window-start runs across a vmapped
    batch (see `fd_mode_sum_uniform` — per-lane offsets degrade the window
    accumulation to scatter; compute them once per batch via
    `band_offsets_for`).

    out_f32=True returns the banded kernel's native f32 spectra instead of
    casting to f64 — the dense pass is f32 throughout, so the cast adds no
    information while writing 2x the bytes over the 1.58M-bin grid; hot
    paths (bench, likelihood) consume f32 and fuse any upcast into their
    reductions. The distance scaling rides the per-mode weights (k_max
    values) rather than a full-grid multiply for the same reason.
    """
    sig = _sigma(table)
    ypr, ypi = pro.y_plus
    ymr, ymi = pro.y_minus
    if channels:
        # W1 = (sigma Y^- + conj(Y^+))/2 ; W2 = i (sigma Y^- - conj(Y^+))/2
        w1 = ((sig * ymr + ypr) * 0.5, (sig * ymi - ypi) * 0.5)
        w2 = (-(sig * ymi + ypi) * 0.5, (sig * ymr - ypr) * 0.5)
        # negative-frequency (direct-term) branch weights: conj(w1), conj(w2)
        w1n = (w1[0], -w1[1])
        w2n = (w2[0], -w2[1])
    else:
        # W1 = sigma Y^-  (htilde at +f); W2 = conj(Y^+) (conj of htilde at -f)
        w1 = (sig * ymr, sig * ymi)
        w2 = (ypr, -ypi)
        # scalar neg-branch: htilde(+f) += C~ Y^+ and conj(htilde(-f)) +=
        # C~ sigma conj(Y^-)  ->  (conj(w2), conj(w1))
        w1n = (ypr, ypi)
        w2n = (sig * ymr, -sig * ymi)

    # distance scaling folded into the k_max-sized weights: a post-kernel
    # multiply would read+write the full grid (4 x nf) once more
    d = pro.dist_factor
    w1 = (w1[0] * d, w1[1] * d)
    w2 = (w2[0] * d, w2[1] * d)
    w1n = (w1n[0] * d, w1n[1] * d)
    w2n = (w2n[0] * d, w2n[1] * d)

    inp = prepare_fd_inputs(
        pro.t_knots,
        pro.n_live,
        pro.phi_phi,
        pro.phi_r,
        pro.a_re,
        pro.a_im,
        table,
        pro.sel,
        w1,
        w2,
        w1n=w1n,
        w2n=w2n,
    )
    if uniform is not None:
        f0, dfreq = uniform
        nf = f_pos.shape[0]
        # auto run size: a mode's band covers only a few percent of the
        # grid, and phase/envelope interpolation needs >= O(300) nodes per
        # band — tiny grids therefore degenerate to node-per-bin (r = 1,
        # no interpolation at all), huge grids amortize with wide runs.
        # When the CALLER supplies band_offsets they are expressed in
        # bins_per_run-sized runs, so the run size must be honored exactly
        # (auto-shrinking it silently misplaced every shared window).
        if band_offsets is not None:
            r_eff = bins_per_run
        else:
            r_eff = max(1, min(bins_per_run, nf // 8192))
        o1r, o1i, o2r, o2i = fd_mode_sum_uniform(
            inp, f0, dfreq, nf, bins_per_run=r_eff, band_runs=band_runs,
            band_offsets=band_offsets, turnover_slots=turnover_slots,
            negative_slots=negative_slots, extra_band_runs=extra_band_runs,
            band_offsets_extra=band_offsets_extra, scan_unroll=scan_unroll,
            slot_unroll=slot_unroll,
            out_dtype=jnp.float32 if out_f32 else None,
        )
    else:
        o1r, o1i, o2r, o2i = fd_mode_sum(
            inp, f_pos, nodes_per_segment=nodes_per_segment,
            turnover_slots=turnover_slots,
            negative_slots=negative_slots,
        )
    return o1r, o1i, o2r, o2i


def _detect_uniform_grid(freq: np.ndarray):
    """Host-side grid classification for the fast uniform kernel.

    Returns ``(f_pos, f0, df, symmetric)`` when the positive part of ``freq``
    is uniformly spaced and the negative part (if any) mirrors it (the
    default odd fftshift grid and ``[::k]`` downsamples of its positive
    half); None for irregular grids (general sorted-kernel path).
    """
    freq = np.asarray(freq)
    pos = freq[freq > 0]
    if len(pos) < 2 or np.any(np.diff(pos) <= 0):
        return None
    df = pos[1] - pos[0]
    if not np.allclose(np.diff(pos), df, rtol=1e-9):
        return None
    neg = freq[freq < 0]
    symmetric = len(neg) > 0
    if symmetric and not np.allclose(neg[::-1], -pos[: len(neg)], rtol=1e-12):
        return None
    if symmetric and len(neg) != len(pos):
        return None
    return pos, float(pos[0]), float(df), symmetric


def _assemble_scalar(freq, pos_v, negc_v, symmetric):
    out = np.zeros(freq.shape, dtype=np.complex128)
    out[freq > 0] = pos_v
    if symmetric:
        out[freq < 0] = np.conj(negc_v)[::-1]
    return out


def _assemble_channels(freq, hp_pos, hc_pos, symmetric):
    hp = np.zeros(freq.shape, dtype=np.complex128)
    hc = np.zeros(freq.shape, dtype=np.complex128)
    hp[freq > 0] = hp_pos
    hc[freq > 0] = hc_pos
    if symmetric:
        hp[freq < 0] = np.conj(hp_pos)[::-1]
        hc[freq < 0] = np.conj(hc_pos)[::-1]
    return hp, hc


def fd_scalar_on_grid(pro: WaveformPrologue, table: ModeTable, freq: jax.Array,
                      turnover_slots: int = 0, negative_slots: int = 0):
    """Scalar htilde = FT(h+ - i hx) on an arbitrary signed frequency grid.

    Evaluates the kernel once at |f| per bin (both branches come out of the
    same pass) and assembles htilde(f>0) = pos, htilde(f<0) = conj(negc),
    htilde(0) = 0 — works for symmetric full grids and arbitrary downsampled
    ``f_arr`` alike. Returns (re, im) f64 arrays.
    """
    f_abs = jnp.maximum(jnp.abs(freq), 1e-300)
    # the two-level kernel requires ascending frequencies; sort + unsort
    order = jnp.argsort(f_abs)
    inv = jnp.argsort(order)
    pr, pi, nr, ni = fd_waveform_core(
        pro, table, f_abs[order], channels=False,
        turnover_slots=turnover_slots, negative_slots=negative_slots,
    )
    pr, pi, nr, ni = pr[inv], pi[inv], nr[inv], ni[inv]
    pos = freq > 0
    neg = freq < 0
    re = jnp.where(pos, pr, jnp.where(neg, nr, 0.0))
    im = jnp.where(pos, pi, jnp.where(neg, -ni, 0.0))
    return re, im


def fd_channels_on_grid(pro: WaveformPrologue, table: ModeTable, freq: jax.Array,
                        turnover_slots: int = 0, negative_slots: int = 0):
    """[h+~, hx~] on an arbitrary signed grid (reality fills f<0 bins).

    Returns ((hp_re, hp_im), (hc_re, hc_im)).
    """
    f_abs = jnp.maximum(jnp.abs(freq), 1e-300)
    # the two-level kernel requires ascending frequencies; sort + unsort
    order = jnp.argsort(f_abs)
    inv = jnp.argsort(order)
    hpr, hpi, hcr, hci = fd_waveform_core(
        pro, table, f_abs[order], channels=True,
        turnover_slots=turnover_slots, negative_slots=negative_slots,
    )
    hpr, hpi, hcr, hci = hpr[inv], hpi[inv], hcr[inv], hci[inv]
    pos = freq > 0
    neg = freq < 0
    sgn = jnp.where(neg, -1.0, 1.0)
    zero = ~(pos | neg)
    hp_re = jnp.where(zero, 0.0, hpr)
    hp_im = jnp.where(zero, 0.0, hpi * sgn)
    hc_re = jnp.where(zero, 0.0, hcr)
    hc_im = jnp.where(zero, 0.0, hci * sgn)
    return (hp_re, hp_im), (hc_re, hc_im)


def band_offsets_for(
    pro: WaveformPrologue,
    table: ModeTable,
    f0: float,
    df: float,
    bins_per_run: int,
    band_runs: int,
    margin_frac: float = 0.125,
) -> np.ndarray:
    """Shared per-mode window-start runs from a representative source.

    Computed ONCE per walker batch (host side, concrete prologue) so the
    vmapped kernel's dynamic-window accumulation stays a true dynamic slice.
    The margin absorbs band drift across nearby walkers; each lane's
    in-range mask keeps correctness regardless (content outside the window
    is dropped, so pick margins generously for wide posteriors).
    """
    from ..ops.cubic_spline import fit_cubic_spline, spline_eval

    t = np.asarray(pro.t_knots)
    sp_pp = fit_cubic_spline(pro.t_knots, pro.phi_phi, bc="not-a-knot")
    sp_pr = fit_cubic_spline(pro.t_knots, pro.phi_r, bc="not-a-knot")
    two_pi = 2.0 * np.pi
    f_phi0 = float(spline_eval(sp_pp, pro.t_knots[:1], deriv=1)[0]) / two_pi
    f_r0 = float(spline_eval(sp_pr, pro.t_knots[:1], deriv=1)[0]) / two_pi
    sel_idx = np.asarray(pro.sel.idx)
    m_sel = table.ms[sel_idx].astype(np.float64)
    n_sel = table.ns[sel_idx].astype(np.float64)
    f_start = m_sel * f_phi0 + n_sel * f_r0
    run_df = bins_per_run * df
    margin = int(band_runs * margin_frac)
    g0 = np.floor((f_start - f0) / run_df).astype(np.int32) - margin
    return np.maximum(g0, 0)


class FrozenSelection(NamedTuple):
    """Batch-shared mode-slot configuration for the banded FD fast path.

    Produced once per walker batch by `freeze_mode_selection` from a
    representative source; holds the slot -> mode map (``forced_idx``), the
    shared window offsets, and the window geometry. Passing per-lane
    (traced) offsets to the banded kernel lowers its window accumulation
    to a scatter (far slower) AND per-lane eps selection shifts slot
    identity whenever a marginal mode crosses the eps boundary — freezing
    both is the production configuration, validated per batch via
    `coverage_of` (the eps semantic: the frozen set must carry >= 1 - eps
    of each lane's mode power).
    """

    forced_idx: np.ndarray  # (k_slots,) candidate-table indices
    band_offsets: np.ndarray  # (k_slots,) window-start runs
    bins_per_run: int
    band_runs: int


def freeze_mode_selection(
    pro: WaveformPrologue,
    table: ModeTable,
    f0: float,
    df: float,
    *,
    k_slots: int | None = None,
    bins_per_run: int = 64,
    band_runs: int | None = None,
    margin_frac: float = 0.125,
    drift_frac: float = 0.02,
) -> FrozenSelection:
    """Build the batch-shared slot layout from a representative prologue.

    ``pro`` should come from `waveform_prologue` with eps selection (its
    ``sel`` orders live slots by band-start frequency). ``k_slots``
    truncates to the leading slots (defaults to the live count + 2 margin
    slots); ``band_runs`` defaults to the widest selected band + offset
    margin + 25% drift headroom, rounded up to a multiple of 64.
    """
    from ..ops.cubic_spline import fit_cubic_spline, spline_eval

    mask = np.asarray(pro.sel.mask)
    if k_slots is None:
        k_slots = min(int(mask.sum()) + 2, len(mask))
    forced = np.asarray(pro.sel.idx)[:k_slots]

    # band widths (in runs) of the kept slots, from the phase-spline
    # derivative at the live knots
    sp_pp = fit_cubic_spline(pro.t_knots, pro.phi_phi, bc="not-a-knot")
    sp_pr = fit_cubic_spline(pro.t_knots, pro.phi_r, bc="not-a-knot")
    two_pi = 2.0 * math.pi
    fphi = np.asarray(spline_eval(sp_pp, pro.t_knots, deriv=1)) / two_pi
    fr = np.asarray(spline_eval(sp_pr, pro.t_knots, deriv=1)) / two_pi
    n_liv = int(pro.n_live)
    ms = table.ms[forced].astype(np.float64)
    ns = table.ns[forced].astype(np.float64)
    fk = ms[:, None] * fphi[None, :n_liv] + ns[:, None] * fr[None, :n_liv]
    width_bins = (fk.max(axis=1) - fk[:, 0]) / df
    # run size adapts to the NARROWEST band: the per-run Hermite/Catmull-Rom
    # interpolation needs >= O(30) runs across a band (short signals chirp
    # so little that a band can be narrower than one 64-bin run)
    bins_per_run = int(np.clip(width_bins.min() // 32, 1, bins_per_run))
    run_df = bins_per_run * df
    # margins scale with each band's absolute frequency POSITION: across a
    # batch the band shifts by ~(posterior param drift) x f, not by a
    # fraction of the band width (drift_frac = 2% covers ~3x the measured
    # shift of a +-0.5%-wide p0/e0 posterior; widen for broader posteriors)
    pos_bins = (fk[:, 0] - f0) / df
    margin_bins = np.maximum(
        drift_frac * (pos_bins + width_bins), margin_frac * width_bins
    )
    if band_runs is None:
        need_bins = width_bins * (1.0 + drift_frac) + 2.0 * margin_bins
        band_runs = int(np.ceil(need_bins.max() / bins_per_run / 64.0) * 64)

    g0 = np.floor((pos_bins - margin_bins) / bins_per_run).astype(np.int32)
    return FrozenSelection(
        forced_idx=forced,
        band_offsets=np.maximum(g0, 0),
        bins_per_run=bins_per_run,
        band_runs=band_runs,
    )


def coverage_of(frozen: FrozenSelection, power: jax.Array) -> jax.Array:
    """Fraction of total mode power the frozen slot set carries (jittable).

    ``power``: (..., n_candidates) per-mode power (from
    `modeselect.mode_power` along a lane's own trajectory). Gate batches
    with ``coverage_of(...) >= 1 - eps`` before trusting the frozen layout
    across a new posterior region.
    """
    kept = jnp.sum(jnp.take(power, jnp.asarray(frozen.forced_idx), axis=-1), axis=-1)
    return kept / jnp.sum(power, axis=-1)


def td_waveform_core(pro: WaveformPrologue, table: ModeTable, t_grid: jax.Array):
    """Dense TD waveform -> (h_plus, h_cross)."""
    hp, hc = td_mode_sum(
        pro.t_knots,
        pro.phi_phi,
        pro.phi_r,
        pro.a_re,
        pro.a_im,
        table,
        pro.sel,
        pro.y_plus,
        pro.y_minus,
        t_grid,
        pro.t_end,
    )
    return hp * pro.dist_factor, hc * pro.dist_factor


def default_time_grid(t_years: float, dt: float) -> np.ndarray:
    """Odd-length dense TD grid (reference ``odd_len=True`` semantics)."""
    n = int(t_years * YRSID_SI / dt)
    if n % 2 == 0:
        n += 1
    return np.arange(n) * dt


def default_frequencies(t_years: float, dt: float) -> np.ndarray:
    """fftshift(fftfreq(N, dt)) for the odd default grid (reference
    ``emri_pe.py:237-247``: frequency goes from -1/(2dt) to 1/(2dt))."""
    n = default_time_grid(t_years, dt).shape[0]
    return np.fft.fftshift(np.fft.fftfreq(n, dt))


class FastSchwarzschildEccentricFlux:
    """Source-frame generator facade (reference call contract).

    Returns numpy complex arrays; production code should use the functional
    cores under its own jit instead.
    """

    def __init__(
        self,
        inspiral_kwargs=None,
        amplitude_kwargs=None,
        Ylm_kwargs=None,
        sum_kwargs=None,
        use_gpu=None,
        n_max: int = 30,
        l_max: int = 6,
        k_max: int = 64,
    ):
        del Ylm_kwargs, use_gpu
        inspiral_kwargs = inspiral_kwargs or {}
        amplitude_kwargs = amplitude_kwargs or {}
        sum_kwargs = sum_kwargs or {}
        # trajectory backend: "dp5" (adaptive stepper) or "quad"
        # (parallel-in-time quadrature, models.trajectory_quad); mirrors the
        # reference's inspiral_kwargs routing (reference emri_pe.py:55-70)
        self.traj_method = inspiral_kwargs.get("method", "dp5")
        self.traj_max_steps = int(inspiral_kwargs.get("max_steps", 512))
        # amplitude physics ladder. The facade defaults to the FULL
        # calibrated stack (wave-tail factor, factorized resummation, RWZ
        # strong-field calibration incl. the eccentric residual table) —
        # the reference's generator is always backed by its best
        # (Teukolsky) amplitude data (reference emri_pe.py:55-57, FD
        # notebook cell 2), so the facade's best physics is its default
        # physics too; pass {"tail": False, ...} to step down the ladder.
        self.tail = bool(amplitude_kwargs.get("tail", True))
        self.factorized = bool(amplitude_kwargs.get("factorized", True))
        self.rwz = bool(amplitude_kwargs.get("rwz", True))
        self.output_type = sum_kwargs.get("output_type", "td")
        self.odd_len = sum_kwargs.get("odd_len", True)
        self.pad_output = sum_kwargs.get("pad_output", False)
        # turnover/negative-frequency branch budgets for the FD kernels
        # (both the arbitrary-f_arr general path and the banded uniform
        # production path carry them since round 3). FD output defaults to
        # 2 turnover slots so plunge-branch content is present by default
        # (reference CUDA kernel behavior: every monotone branch evaluated);
        # the second scan's narrow window budget keeps dead slots cheap.
        default_ts = 2 if sum_kwargs.get("output_type", "td") == "fd" else 0
        self.turnover_slots = int(sum_kwargs.get("turnover_slots", default_ts))
        self.negative_slots = int(sum_kwargs.get("negative_slots", 0))
        # trajectory dissipation: default is the calibrated mode-sum flux,
        # energy-balanced with the default rwz amplitude stack (the
        # reference trajectory is likewise driven by its Teukolsky flux
        # data, reference emri_pe.py:620)
        self.flux = sum_kwargs.get("flux", "multipole_rwz")
        self.table = default_mode_table(n_max, l_max=l_max)
        self.k_max = k_max
        self.frequency = None

    def __call__(
        self,
        M,
        mu,
        p0,
        e0,
        theta,
        phi,
        *,
        dist=1.0,
        T=1.0,
        dt=10.0,
        eps=1e-5,
        mode_selection=None,
        f_arr=None,
        mask_positive=False,
        Phi_phi0=0.0,
        Phi_r0=0.0,
        return_channels=False,
    ):
        forced = (
            table_indices_for(self.table, mode_selection) if mode_selection is not None else None
        )
        pro = waveform_prologue(
            M, mu, p0, e0, theta, phi, dist, Phi_phi0, Phi_r0,
            t_years=float(T), table=self.table,
            k_max=len(forced) if forced is not None else self.k_max,
            eps=eps, forced_idx=forced, flux=self.flux, tail=self.tail,
            factorized=self.factorized, rwz=self.rwz,
            max_steps=self.traj_max_steps, traj_method=self.traj_method,
        )
        if self.output_type == "td":
            t_grid = jnp.asarray(default_time_grid(float(T), float(dt)))
            hp, hc = td_waveform_core(pro, self.table, t_grid)
            if return_channels:
                return [np.asarray(hp), np.asarray(hc)]
            return np.asarray(hp) - 1j * np.asarray(hc)
        # FD on the default symmetric grid or arbitrary user f_arr (no
        # symmetry assumed: the kernel computes both +-f branches at |f|).
        if f_arr is None:
            freq = default_frequencies(float(T), float(dt))
        else:
            freq = np.asarray(f_arr)
        self.frequency = freq
        uni = _detect_uniform_grid(freq)
        if uni is not None:
            f_pos_np, f0, dfreq, symmetric = uni
            o1r, o1i, o2r, o2i = fd_waveform_core(
                pro, self.table, jnp.asarray(f_pos_np),
                channels=return_channels, uniform=(f0, dfreq),
                turnover_slots=self.turnover_slots,
                negative_slots=self.negative_slots,
            )
            if return_channels:
                hp_pos = np.asarray(o1r) + 1j * np.asarray(o1i)
                hc_pos = np.asarray(o2r) + 1j * np.asarray(o2i)
                hp, hc = _assemble_channels(freq, hp_pos, hc_pos, symmetric)
                if mask_positive:
                    keep = freq >= 0
                    return [hp[keep], hc[keep]]
                return [hp, hc]
            pos_v = np.asarray(o1r) + 1j * np.asarray(o1i)
            negc_v = np.asarray(o2r) + 1j * np.asarray(o2i)
            out = _assemble_scalar(freq, pos_v, negc_v, symmetric)
            if mask_positive:
                return out[freq >= 0]
            return out
        if return_channels:
            (hpr, hpi), (hcr, hci) = fd_channels_on_grid(
                pro, self.table, jnp.asarray(freq),
                turnover_slots=self.turnover_slots,
                negative_slots=self.negative_slots,
            )
            hp = np.asarray(hpr) + 1j * np.asarray(hpi)
            hc = np.asarray(hcr) + 1j * np.asarray(hci)
            if mask_positive:
                keep = freq >= 0
                return [hp[keep], hc[keep]]
            return [hp, hc]
        h = fd_scalar_on_grid(
            pro, self.table, jnp.asarray(freq),
            turnover_slots=self.turnover_slots,
            negative_slots=self.negative_slots,
        )
        out = np.asarray(h[0]) + 1j * np.asarray(h[1])
        if mask_positive:
            return out[freq >= 0]
        return out


def detector_frame_angles(qS, phiS, qK, phiK):
    """(theta, phi, psi): source-frame viewing angles + polarization rotation."""
    sR = jnp.stack(
        [jnp.sin(qS) * jnp.cos(phiS), jnp.sin(qS) * jnp.sin(phiS), jnp.cos(qS)]
    )
    lhat = jnp.stack(
        [jnp.sin(qK) * jnp.cos(phiK), jnp.sin(qK) * jnp.sin(phiK), jnp.cos(qK)]
    )
    khat = -sR  # propagation: source -> SSB
    ct = -jnp.dot(khat, lhat)  # viewing direction from source = -khat = R
    ct = jnp.clip(ct, -1.0, 1.0)
    theta = jnp.arccos(ct)

    # source-frame basis: z = Lhat, x = projection of SSB z onto plane
    zhat = jnp.array([0.0, 0.0, 1.0])
    xs = zhat - jnp.dot(zhat, lhat) * lhat
    xs_norm = jnp.linalg.norm(xs)
    # degenerate when L || z: fall back to SSB x-axis
    xs = jnp.where(xs_norm > 1e-12, xs / jnp.maximum(xs_norm, 1e-12), jnp.array([1.0, 0.0, 0.0]))
    ys = jnp.cross(lhat, xs)
    view = sR  # unit vector toward observer, in SSB coords
    phi = jnp.arctan2(jnp.dot(view, ys), jnp.dot(view, xs))

    # polarization: source-frame transverse basis at the viewing point
    e_th_src = jnp.cross(view, jnp.cross(lhat, view))
    e_th_src = -e_th_src / jnp.maximum(jnp.linalg.norm(e_th_src), 1e-12)
    e_ph_src = jnp.cross(view, e_th_src)
    e_ph_src = e_ph_src / jnp.maximum(jnp.linalg.norm(e_ph_src), 1e-12)
    # SSB sky basis at (qS, phiS)
    e_th_ssb = jnp.stack(
        [jnp.cos(qS) * jnp.cos(phiS), jnp.cos(qS) * jnp.sin(phiS), -jnp.sin(qS)]
    )
    e_ph_ssb = jnp.stack([-jnp.sin(phiS), jnp.cos(phiS), jnp.zeros_like(phiS)])
    psi = jnp.arctan2(jnp.dot(e_th_src, e_ph_ssb), jnp.dot(e_th_src, e_th_ssb))
    return theta, phi, psi


def rotate_polarizations(hp, hc, psi):
    c2, s2 = jnp.cos(2.0 * psi), jnp.sin(2.0 * psi)
    return hp * c2 - hc * s2, hp * s2 + hc * c2


class GenerateEMRIWaveform:
    """Detector-frame 14-parameter facade (reference ``emri_pe.py:86-121``)."""

    def __init__(
        self,
        waveform_class: str = "FastSchwarzschildEccentricFlux",
        sum_kwargs=None,
        amplitude_kwargs=None,
        inspiral_kwargs=None,
        return_list: bool = False,
        use_gpu=None,
        frame: str = "detector",
        n_max: int = 30,
        l_max: int = 6,
        k_max: int = 64,
    ):
        if waveform_class != "FastSchwarzschildEccentricFlux":
            raise NotImplementedError(waveform_class)
        self.waveform_generator = FastSchwarzschildEccentricFlux(
            sum_kwargs=sum_kwargs, amplitude_kwargs=amplitude_kwargs,
            inspiral_kwargs=inspiral_kwargs,
            n_max=n_max, l_max=l_max, k_max=k_max
        )
        self.return_list = return_list
        self.frame = frame
        # parity shim: reference exposes .waveform_generator.create_waveform.frequency
        self.waveform_generator.create_waveform = self.waveform_generator

    @property
    def frequency(self):
        return self.waveform_generator.frequency

    def __call__(
        self,
        M,
        mu,
        a,
        p0,
        e0,
        x0,
        dist,
        qS,
        phiS,
        qK,
        phiK,
        Phi_phi0,
        Phi_theta0,
        Phi_r0,
        *,
        T=1.0,
        dt=10.0,
        eps=1e-5,
        mode_selection=None,
        f_arr=None,
        mask_positive=False,
    ):
        del a, x0, Phi_theta0
        if self.frame == "source":
            theta, phi, psi = jnp.asarray(qS), jnp.asarray(phiS), jnp.asarray(0.0)
        else:
            theta, phi, psi = detector_frame_angles(
                jnp.asarray(qS), jnp.asarray(phiS), jnp.asarray(qK), jnp.asarray(phiK)
            )
        hp, hc = self.waveform_generator(
            M, mu, p0, e0, theta, phi,
            dist=dist, T=T, dt=dt, eps=eps, mode_selection=mode_selection,
            f_arr=f_arr, mask_positive=mask_positive,
            Phi_phi0=Phi_phi0, Phi_r0=Phi_r0,
            return_channels=True,
        )
        # rotate polarizations by 2 psi (identical in TD and FD: the
        # rotation is a real linear map on the [h+, hx] pair per sample/bin)
        c2, s2 = float(jnp.cos(2 * psi)), float(jnp.sin(2 * psi))
        hp2, hc2 = hp * c2 - hc * s2, hp * s2 + hc * c2
        if self.return_list:
            return [hp2, hc2]
        return hp2 - 1j * hc2


__all__ = [
    "WaveformPrologue",
    "waveform_prologue",
    "fd_waveform_core",
    "td_waveform_core",
    "FrozenSelection",
    "freeze_mode_selection",
    "coverage_of",
    "default_time_grid",
    "default_frequencies",
    "FastSchwarzschildEccentricFlux",
    "GenerateEMRIWaveform",
    "detector_frame_angles",
    "rotate_polarizations",
]
