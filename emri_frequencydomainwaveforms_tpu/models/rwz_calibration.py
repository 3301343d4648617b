"""Strong-field amplitude calibration from the in-repo RWZ solver.

The factorized resummation (`models.rho`) is exact through its anchored
PN orders; beyond them (and for the l = 5, 6 families with no published
test-mass rho series at all) it truncates. This module applies the
residual modulus correction

    A_lmn  ->  A_lmn * B_lm(x_mn),      x_mn = (|omega_mn| / m)^(2/3),

where B_lm is the exact/model flux ratio computed by the repo's own
first-principles Regge-Wheeler/Zerilli solver on circular Schwarzschild
orbits (tools/rwz/: master equations DERIVED from the linearized
Einstein equations, validated against the published PN series to 1e-6 —
see tests/test_rwz.py). Same circular-equivalent prescription as rho_lm;
the eccentric residual beyond it is the remaining (stated) error bar.

With ``rwz=True`` the circular-limit amplitude moduli and per-mode
fluxes are EXACT (to solver accuracy ~1e-6) at every PN order — the
content the reference obtains from its precomputed Teukolsky data
(reference Tutorial_FD_construction_single_mode.ipynb cell 2
`RomanAmplitude`; data files not redistributable, so this repo computes
the physics instead).

On top of B_lm(x_mn), `rwz_ecc_residual` applies the genuinely eccentric
per-(l, m, n) residual R_lmn(u, e) from the eccentric-source RWZ solver
(tools/rwz/eccentric.py, table generated by tools/rwz/calibrate_ecc.py):
bilinear on the package's regular (u, e) orbit grid, modes without a
calibrated row fall back to R = 1 (i.e. the circular-equivalent
prescription alone).

Evaluation strategy: both corrections evaluate their tables as DENSE
CARDINAL-WEIGHT CONTRACTIONS instead of fancy-index gathers —
mathematically identical interpolation (Keys/Catmull-Rom cardinal), but
gather-free: small f32 einsums (the corrections multiply f32-precision
amplitudes, so f32 is free). The gather-free choice was made for the
accelerator this code was first written for; whether it still pays on a
GPU is ROADMAP Speed item 4.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ._rwz_calibration_data import B_TABLE, N_X, X_HI, X_LO

try:  # table generated by tools/rwz/calibrate_ecc.py (optional until run)
    from . import _rwz_ecc_data as _ecc
except ImportError:  # pragma: no cover - pre-generation fallback
    _ecc = None

_LOG_LO = float(np.log(X_LO))
_DT = float((np.log(X_HI) - np.log(X_LO)) / (N_X - 1))


def _mode_rows(ls: np.ndarray, ms: np.ndarray) -> np.ndarray:
    """(n_modes, N_X + 2) static B rows with edge-replicated ghost nodes
    (reproducing the index-clamped Catmull-Rom stencil exactly);
    uncalibrated modes get ones."""
    ones = np.ones(N_X)
    rows = np.stack(
        [
            B_TABLE.get((int(l), int(abs(m))), ones)
            for l, m in zip(np.asarray(ls), np.asarray(ms))
        ]
    )
    return np.concatenate([rows[:, :1], rows, rows[:, -1:]], axis=1)


def _keys_cardinal(s):
    """Keys/Catmull-Rom cardinal c(s) (a = -1/2), support |s| < 2."""
    a = jnp.abs(s)
    inner = (1.5 * a - 2.5) * a * a + 1.0
    outer = ((-0.5 * a + 2.5) * a - 4.0) * a + 2.0
    return jnp.where(a < 1.0, inner, jnp.where(a < 2.0, outer, 0.0))


def rwz_correction(ls: np.ndarray, ms: np.ndarray, x) -> jnp.ndarray:
    """B_lm(x) per mode; ``x`` shaped (..., n_modes) (static ls/ms).

    Catmull-Rom on the uniform log-x grid, evaluated as a dense cardinal
    contraction over the (ghost-padded) node axis — identical values to
    the index-clamped 4-point stencil, no gathers.
    """
    rows = jnp.asarray(_mode_rows(ls, ms), jnp.float32)  # (M, N_X + 2)
    dt = jnp.asarray(x).dtype
    t = (jnp.log(jnp.maximum(x, 1e-30)) - _LOG_LO) / _DT
    t = jnp.clip(t, 0.0, N_X - 1.0).astype(jnp.float32)
    # padded node positions -1 .. N_X
    nodes = jnp.asarray(np.arange(-1, N_X + 1), jnp.float32)
    w = _keys_cardinal(t[..., None] - nodes)  # (..., M, N_X + 2)
    return jnp.sum(w * rows, axis=-1).astype(dt)


def rwz_ecc_residual(
    ls: np.ndarray, ms: np.ndarray, ns: np.ndarray, u, e
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """COMPLEX eccentric residual R_lmn(u, e) per mode -> (re, im) pair
    (real arithmetic; (1, 0) where uncalibrated).

    ``u``/``e`` are the trajectory coordinates (u = log(p - p_sep +
    U_SHIFT), models/amplitude_backends.u_of_pe), shaped (...); outputs
    broadcast to (..., n_modes). Keys-cardinal BICUBIC with edge-
    replicated ghosts, evaluated as dense weight contractions
    (node-exact, C^1, gather-free; the (u, e) weights are shared across
    the mode axis). Bicubic rather than bilinear since round 4: the
    recleaned table keeps real node-scale structure, and the bilinear
    KINKS at grid lines put derivative discontinuities into A(t) along
    the trajectory that the banded FD kernel's run-level interpolation
    cannot follow (measured: 6e-4 banded/general kernel disagreement,
    vs 1e-5 with a C^1 field). R -> 1 smoothly at the low-e edge is a
    property of the data, not enforced. |R| corrects the modulus, arg R
    the strong-field per-mode phase (~0.1 rad near the separatrix; phase
    conventions agree exactly at Newtonian order, see
    tools/rwz/calibrate_ecc.py).
    """
    dt = jnp.asarray(u).dtype
    if _ecc is None:
        shape = jnp.shape(u) + (len(np.asarray(ls)),)
        return jnp.ones(shape, dtype=dt), jnp.zeros(shape, dtype=dt)
    ones = np.ones((_ecc.N_U, _ecc.N_E), dtype=complex)
    rows = np.stack(
        [
            _ecc.R_TABLE.get((int(l), int(m), int(n)), ones)
            for l, m, n in zip(np.asarray(ls), np.asarray(ms), np.asarray(ns))
        ]
    )  # (M, N_U, N_E) complex host-side; split to a real pair
    # edge-replicated ghosts (same clamped-stencil semantics as B)
    rows = np.concatenate([rows[:, :1], rows, rows[:, -1:]], axis=1)
    rows = np.concatenate([rows[:, :, :1], rows, rows[:, :, -1:]], axis=2)
    rows_re = jnp.asarray(rows.real, jnp.float32)
    rows_im = jnp.asarray(rows.imag, jnp.float32)

    tu = (jnp.asarray(u) - _ecc.U0) / _ecc.DU
    te = (jnp.asarray(e) - _ecc.E0) / _ecc.DE
    tu = jnp.clip(tu, 0.0, _ecc.N_U - 1.0).astype(jnp.float32)
    te = jnp.clip(te, 0.0, _ecc.N_E - 1.0).astype(jnp.float32)
    nodes_u = jnp.asarray(np.arange(-1, _ecc.N_U + 1), jnp.float32)
    nodes_e = jnp.asarray(np.arange(-1, _ecc.N_E + 1), jnp.float32)
    wu = _keys_cardinal(tu[..., None] - nodes_u)  # (..., N_U + 2)
    we = _keys_cardinal(te[..., None] - nodes_e)  # (..., N_E + 2)

    def bicub(rows_j):
        # HIGHEST: a default-precision f32 contraction may run in TF32 on
        # the GPU (~10 mantissa bits)
        inner = jnp.einsum(
            "...u,mue->...me", wu, rows_j, precision=jax.lax.Precision.HIGHEST
        )
        return jnp.sum(inner * we[..., None, :], axis=-1)

    r_re = bicub(rows_re)
    r_im = bicub(rows_im)
    # bounded-correction contract: the generator accepts node residuals
    # only in (0.2, 5), but the cubic cardinal can over/undershoot
    # between sharp node-scale jumps (model-amplitude zero crossings) —
    # clamp the interpolated MODULUS back into the accepted band
    mag = jnp.sqrt(r_re * r_re + r_im * r_im)
    scale = jnp.clip(mag, 0.15, 6.0) / jnp.maximum(mag, 1e-30)
    return (r_re * scale).astype(dt), (r_im * scale).astype(dt)


__all__ = ["rwz_correction", "rwz_ecc_residual"]
