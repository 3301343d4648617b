"""LISA noise PSDs / sensitivity curves (jittable).

Rebuilds the capability surface of the reference's
``LISAanalysistools/lisatools/sensitivity.py`` (PSD zoo + dispatcher,
pinned at reference ``sensitivity.py:435-603`` TDI PSDs, ``:604-744``
galactic confusion, ``:746`` lisanoises, ``:1227`` cornish_lisa_psd,
``:1289`` get_sensitivity; ``AET`` combination at ``:90``) from the
published formulas:

* Robson-Cornish-Liu analytic sky-averaged PSD incl. 1-yr galactic
  foreground (arXiv:1803.01944 eqs. 1-4, 9-14);
* SciRDv1 instrument noises (ESA LISA Science Requirements; the same
  acceleration/OMS forms the reference's ``lisanoises`` evaluates);
* first-generation TDI X/A/E/T PSDs (standard MLDC expressions);
* galactic-confusion fit with observation-time-dependent knee.

All functions are pure jnp and broadcast over ``f``; they run under jit in
f64 and are used by the likelihood's whitening. The reference also
ships a tabulated file-based curve (``LISA_Alloc_Sh.txt`` via
``FDutils.py:21-33``); `sensitivity_from_table` loads any such 2-column
table supplied by the user.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


def _xp(f):
    """Array namespace of the input: numpy in -> numpy math (true f64).

    Load-bearing on the accelerator this package was first built for, whose
    device "f64" was a double-float emulation that FLUSHED values below the
    f32 normal range (~1e-38) to zero (ROADMAP Design item 2 asks whether
    the host-side split still pays on the GPU) — LISA PSDs
    are ~1e-41..1e-36 strain^2/Hz, so evaluating them on-device silently
    zeroes the likelihood whitening. Host-side callers (injection, inner
    products) pass numpy arrays and get exact IEEE f64; jitted in-graph use
    with traced arrays still works via jnp (rescale strains there instead).
    """
    return np if isinstance(f, (np.ndarray, np.generic, float, int)) else jnp

C_SI = 299_792_458.0
L_ARM = 2.5e9  # m
F_STAR = C_SI / (2.0 * math.pi * L_ARM)  # ~19.09 mHz


def _pm_acc_noise(f, model: str = "SciRDv1"):
    """Acceleration (proof-mass) noise S_pm [relative frequency units⁻ʰᶻ].

    Returns displacement-equivalent acceleration PSD in m^2 s^-4 / Hz.
    """
    if model in ("SciRDv1", "MRDv1", "Proposal"):
        a = {"Proposal": 3e-15, "SciRDv1": 3e-15, "MRDv1": 2.4e-15}[model]
        return (a**2) * (1.0 + (0.4e-3 / f) ** 2) * (1.0 + (f / 8e-3) ** 4)
    raise ValueError(f"unknown acceleration-noise model {model!r}")


def _oms_noise(f, model: str = "SciRDv1"):
    """Optical-metrology (shot/OMS) displacement noise in m^2 / Hz."""
    if model in ("SciRDv1", "MRDv1"):
        p = 15e-12
    elif model == "Proposal":
        p = 1.5e-11
    else:
        raise ValueError(f"unknown OMS-noise model {model!r}")
    return (p**2) * (1.0 + (2e-3 / f) ** 4)


def lisanoises(f, model: str = "SciRDv1", unit: str = "relativeFrequency"):
    """(S_pm, S_op) converted to fractional-frequency units if requested.

    Mirrors the reference ``lisanoises`` contract (``sensitivity.py:746``).
    """
    spm_d = _pm_acc_noise(f, model)
    sop_d = _oms_noise(f, model)
    if unit == "displacement":
        return spm_d / (2.0 * math.pi * f) ** 4, sop_d
    # relative frequency (Doppler) units
    spm = spm_d * (2.0 * math.pi * f) ** -4 * (2.0 * math.pi * f / C_SI) ** 2
    sop = sop_d * (2.0 * math.pi * f / C_SI) ** 2
    return spm, sop


def galactic_confusion(f, t_obs_years: float = 4.0):
    """Galactic WD foreground fit S_c(f) (arXiv:1803.01944 eq. 14)."""
    xp = _xp(f)
    pars = {
        0.5: (0.133, 243.0, 482.0, 917.0, 2.58e-3),
        1.0: (0.171, 292.0, 1020.0, 1680.0, 2.15e-3),
        2.0: (0.165, 299.0, 611.0, 1340.0, 1.73e-3),
        4.0: (0.138, -221.0, 521.0, 1680.0, 1.13e-3),
    }
    key = min(pars.keys(), key=lambda k: abs(k - t_obs_years))
    alpha, beta, kappa, gamma, fk = pars[key]
    amp = 9e-45
    return (
        amp
        * f ** (-7.0 / 3.0)
        * xp.exp(-(f**alpha) + beta * f * xp.sin(kappa * f))
        # clamp: an emulated-f64 tanh misbehaves at large |x| (saturated anyway)
        * (1.0 + xp.tanh(xp.clip(gamma * (fk - f), -20.0, 20.0)))
    )


def cornish_lisa_psd(f, sky_averaged: bool = True, t_obs_years: float = 1.0):
    """Analytic sky-averaged LISA sensitivity (arXiv:1803.01944 eqs. 1-13).

    Pins reference ``sensitivity.py:1227`` (same paper) including the
    galactic background term.
    """
    xp = _xp(f)
    p_oms = (1.5e-11) ** 2 * (1.0 + (2e-3 / f) ** 4)
    p_acc = (3e-15) ** 2 * (1.0 + (0.4e-3 / f) ** 2) * (1.0 + (f / 8e-3) ** 4)
    pn = (
        p_oms + 2.0 * (1.0 + xp.cos(f / F_STAR) ** 2) * p_acc / (2.0 * math.pi * f) ** 4
    ) / L_ARM**2
    sky_fac = 10.0 / 3.0 if sky_averaged else 1.0
    sn = sky_fac * pn * (1.0 + 0.6 * (f / F_STAR) ** 2)
    return sn + galactic_confusion(f, t_obs_years)


def lisasens(f, model: str = "SciRDv1", t_obs_years: float = 4.0, include_confusion: bool = True):
    """Sky-averaged sensitivity PSD from the SciRDv1 instrument noises."""
    sop = _oms_noise(f, model)
    spm = _pm_acc_noise(f, model) / (2.0 * math.pi * f) ** 4
    sn = (10.0 / 3.0) / L_ARM**2 * (sop + 4.0 * spm) * (1.0 + 0.6 * (f / F_STAR) ** 2)
    if include_confusion:
        sn = sn + galactic_confusion(f, t_obs_years)
    return sn


def _tdi_xs(f, model="SciRDv1"):
    x = 2.0 * math.pi * f * L_ARM / C_SI
    spm, sop = lisanoises(f, model)
    return x, spm, sop


def noisepsd_X(f, model: str = "SciRDv1"):
    """First-generation TDI X PSD (MLDC convention, reference ``:435``)."""
    x, spm, sop = _tdi_xs(f, model)
    xp = _xp(f)
    return 16.0 * xp.sin(x) ** 2 * (2.0 * (1.0 + xp.cos(x) ** 2) * spm + sop)


def noisepsd_XY(f, model: str = "SciRDv1"):
    """TDI X-Y cross PSD."""
    x, spm, sop = _tdi_xs(f, model)
    xp = _xp(f)
    return -4.0 * xp.sin(2.0 * x) * xp.sin(x) * (sop + 4.0 * spm)


def noisepsd_AE(f, model: str = "SciRDv1", t_obs_years: float = 4.0, include_confusion: bool = False):
    """TDI A/E PSD (reference ``noisepsd_AE``)."""
    x, spm, sop = _tdi_xs(f, model)
    xp = _xp(f)
    psd = 8.0 * xp.sin(x) ** 2 * (
        2.0 * spm * (3.0 + 2.0 * xp.cos(x) + xp.cos(2.0 * x))
        + sop * (2.0 + xp.cos(x))
    )
    if include_confusion:
        psd = psd + wd_confusion_AE(f, t_obs_years)
    return psd


def noisepsd_X2(f, model: str = "SciRDv1"):
    """Second-generation TDI X2 PSD (reference ``sensitivity.py:461``).

    The 2nd-gen (time-varying-armlength-immune) combination applies one more
    round of delayed differencing, multiplying the 1st-gen response by the
    extra transfer factor 4 sin^2(2x): the reference's expanded form
    ``64 sin^2 x sin^2 2x Sop + 256 (3 + cos 2x) cos^2 x sin^4 x Spm`` is
    algebraically identical (``256(3 + cos2x)cos^2 x sin^4 x =
    4 sin^2 2x * 32 sin^2 x (1 + cos^2 x)``), which the tests pin.
    """
    x, _, _ = _tdi_xs(f, model)
    xp = _xp(f)
    return 4.0 * xp.sin(2.0 * x) ** 2 * noisepsd_X(f, model)


def noisepsd_AE2(f, model: str = "SciRDv1", t_obs_years: float = 4.0, include_confusion: bool = False):
    """Second-generation TDI A2/E2 PSD (reference ``sensitivity.py:545``):
    ``32 sin^2 x sin^2 2x (2 Spm (3 + 2cos x + cos 2x) + Sop (2 + cos x))``
    = 4 sin^2(2x) * noisepsd_AE."""
    x, _, _ = _tdi_xs(f, model)
    xp = _xp(f)
    psd = 4.0 * xp.sin(2.0 * x) ** 2 * noisepsd_AE(f, model)
    if include_confusion:
        psd = psd + 4.0 * xp.sin(2.0 * x) ** 2 * wd_confusion_AE(f, t_obs_years)
    return psd


def noisepsd_T(f, model: str = "SciRDv1"):
    """TDI T (null-channel) PSD."""
    x, spm, sop = _tdi_xs(f, model)
    xp = _xp(f)
    return (
        16.0 * sop * (1.0 - xp.cos(x)) * xp.sin(x) ** 2
        + 128.0 * spm * xp.sin(x) ** 2 * xp.sin(0.5 * x) ** 4
    )


def _strain_to_tdi_x_factor(f):
    """Approximate |R| mapping strain PSD -> TDI-X units (long-wavelength)."""
    xp = _xp(f)
    x = 2.0 * math.pi * f * L_ARM / C_SI
    return 16.0 * x**2 * xp.sin(x) ** 2 * (3.0 / 10.0) / (1.0 + 0.6 * x**2)


def wd_confusion_X(f, t_obs_years: float = 4.0):
    """Galactic confusion projected into TDI X units (reference ``WDconfusionX``)."""
    return galactic_confusion(f, t_obs_years) * _strain_to_tdi_x_factor(f)


def wd_confusion_AE(f, t_obs_years: float = 4.0):
    return 1.5 * wd_confusion_X(f, t_obs_years)


def AET(X, Y, Z):
    """Orthogonal TDI combination (reference ``sensitivity.py:90``)."""
    sqrt2 = math.sqrt(2.0)
    sqrt3 = math.sqrt(3.0)
    sqrt6 = math.sqrt(6.0)
    A = (Z - X) / sqrt2
    E = (X - 2.0 * Y + Z) / sqrt6
    T = (X + Y + Z) / sqrt3
    return A, E, T


_SENS_FNS = {
    "cornish_lisa_psd": cornish_lisa_psd,
    "lisasens": lisasens,
    "noisepsd_X": noisepsd_X,
    "noisepsd_XY": noisepsd_XY,
    "noisepsd_AE": noisepsd_AE,
    "noisepsd_X2": noisepsd_X2,
    "noisepsd_AE2": noisepsd_AE2,
    "noisepsd_T": noisepsd_T,
}


def get_sensitivity(f, sens_fn="lisasens", return_type: str = "PSD", **kwargs):
    """Dispatcher pinning reference ``get_sensitivity`` (``:1289``).

    ``return_type``: "PSD", "ASD" (sqrt), or "char_strain" (sqrt(f * PSD)).
    """
    fn = _SENS_FNS[sens_fn] if isinstance(sens_fn, str) else sens_fn
    xp = _xp(f)
    psd = fn(f, **kwargs)
    if return_type == "PSD":
        return psd
    if return_type == "ASD":
        return xp.sqrt(psd)
    if return_type == "char_strain":
        return xp.sqrt(f * psd)
    raise ValueError(f"unknown return_type {return_type!r}")


def sensitivity_from_table(path: str):
    """Cubic-interpolated Sh(f) from a 2-column (f, Sh) text table.

    Mirrors the reference's file-based curve (``FDutils.py:21-33`` over
    ``LISA_Alloc_Sh.txt``); the table is user-supplied.
    """
    data = np.loadtxt(path)
    from ..ops.cubic_spline import fit_cubic_spline, spline_eval

    logf = jnp.asarray(np.log(data[:, 0]))
    logs = jnp.asarray(np.log(data[:, 1]))
    sp = fit_cubic_spline(logf, logs)

    def sh(f):
        return jnp.exp(spline_eval(sp, jnp.log(jnp.asarray(f))))

    return sh


__all__ = [
    "lisanoises",
    "galactic_confusion",
    "cornish_lisa_psd",
    "lisasens",
    "noisepsd_X",
    "noisepsd_XY",
    "noisepsd_AE",
    "noisepsd_X2",
    "noisepsd_AE2",
    "noisepsd_T",
    "wd_confusion_X",
    "wd_confusion_AE",
    "AET",
    "get_sensitivity",
    "sensitivity_from_table",
]
