"""FD-construction walkthrough: the single-mode stationary-phase build.

Runnable port of the reference's pedagogy notebook
``Tutorial_FD_construction_single_mode.ipynb`` (cells 22-32): construct the
frequency-domain waveform of ONE harmonic step by step — trajectory, phase
spline, frequency evolution and its inversion t(f), the SPA amplitude with
the uniform Bessel-K(1/3) correction — then check it against the FFT of the
time-domain waveform built from the SAME splines, exactly the comparison
the notebook plots ("fd_h vs fft(td_h) * dt").

Run (CI-quick by default; pass --plot for figures):

    PYTHONPATH=. python examples/fd_construction.py
    PYTHONPATH=. JAX_PLATFORMS=cpu python examples/fd_construction.py  # CPU
"""

import argparse

import numpy as np

import emri_frequencydomainwaveforms_tpu  # noqa: F401  (f64 config)
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.models.amplitude import (
    ModeTable,
    default_mode_table,
)
from emri_frequencydomainwaveforms_tpu.models.waveform import (
    _sigma,
    default_frequencies,
    default_time_grid,
    fd_waveform_core,
    td_waveform_core,
    waveform_prologue,
)
from emri_frequencydomainwaveforms_tpu.ops.cubic_spline import (
    fit_cubic_spline,
    spline_eval,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--T", type=float, default=0.1, help="observation years")
    args = ap.parse_args()

    # ---- source (notebook cell 2's tutorial configuration, shortened) ----
    M, mu, p0, e0 = 1e6, 10.0, 11.0, 0.35
    theta, phi = 0.7, 0.5
    T, dt = args.T, 10.0

    # ---- step 1: trajectory + phases (notebook cells 5-9) ----
    # waveform_prologue = trajectory ODE -> amplitudes -> eps selection ->
    # spline-ready knots; the single (2,2,0) mode is forced explicitly
    table = ModeTable(np.array([2]), np.array([2]), np.array([0]))
    pro = waveform_prologue(
        M, mu, p0, e0, theta, phi, 1.0, 0.0, 0.0,
        t_years=T, table=table, k_max=1, eps=1e-9,
    )
    n_live = int(pro.n_live)
    print(f"trajectory: {n_live} adaptive knots over {T} yr")

    # ---- step 2: the mode's phase and frequency evolution (cells 11-17) ----
    sp_phi = fit_cubic_spline(pro.t_knots, pro.phi_phi, bc="not-a-knot")
    t_knots = np.asarray(pro.t_knots)[:n_live]
    f_mode = np.asarray(spline_eval(sp_phi, pro.t_knots, deriv=1))[:n_live]
    f_mode = 2.0 * f_mode / (2.0 * np.pi)  # m = 2, n = 0: f = 2 Omega_phi/2pi
    print(
        f"f_22 sweeps {f_mode[0] * 1e3:.4f} -> {f_mode[-1] * 1e3:.4f} mHz "
        "(monotone chirp, invertible t(f))"
    )
    assert np.all(np.diff(f_mode) > 0), "monotone band required for t(f)"

    # ---- step 3: FD via the SPA kernel (cells 22-26) ----
    freq = default_frequencies(T, dt)
    f_pos = jnp.asarray(freq[freq > 0])
    hp_r, hp_i, hc_r, hc_i = fd_waveform_core(pro, table, f_pos, channels=True)
    fd_hp = np.asarray(hp_r) + 1j * np.asarray(hp_i)
    fd_hc = np.asarray(hc_r) + 1j * np.asarray(hc_i)
    band = (np.asarray(f_pos) >= f_mode[0]) & (np.asarray(f_pos) <= f_mode[-1])
    print(
        f"FD kernel: {band.sum()} in-band bins of {len(fd_hp)}; "
        f"peak |h+~| = {np.abs(fd_hp).max():.3e}"
    )

    # ---- step 4: the notebook's ground-truth check (cells 26-32):
    # fft(td_h) * dt from the SAME splines must overlay the SPA result ----
    t_grid = jnp.asarray(default_time_grid(T, dt))
    hp_td, hc_td = td_waveform_core(pro, table, t_grid)
    hp_td, hc_td = np.asarray(hp_td), np.asarray(hc_td)
    w = np.hanning(len(hp_td))  # windowing tames spectral leakage (cell 28)
    from emri_frequencydomainwaveforms_tpu.utils.fdutils import (
        get_fd_windowed,
        get_fft_td_windowed,
    )

    td_w = get_fft_td_windowed([hp_td, hc_td], w, dt)
    full_hp = np.zeros(len(freq), complex)
    full_hp[freq > 0] = fd_hp
    full_hp[freq < 0] = np.conj(fd_hp)[::-1]
    fd_hp_w = get_fd_windowed([full_hp], w)[0]

    pos = freq > 0
    fft_hp = td_w[0][pos]
    fd_cmp = fd_hp_w[pos]
    num = np.abs(np.vdot(fd_cmp, fft_hp))
    den = np.sqrt(np.vdot(fd_cmp, fd_cmp).real * np.vdot(fft_hp, fft_hp).real)
    mismatch = 1.0 - num / den
    print(f"single-mode FD vs fft(TD)*dt Hann mismatch: {mismatch:.3e}")
    # SPA truncation scales as 1/w ~ fddot^2/fdot^3: slow short chirps sit
    # higher (T=0.1 yr: ~5e-3; T=0.35: ~4e-4; the 1-yr production config
    # reaches the paper-level ~7e-5 — bench.py gate 2 enforces it each run)
    gate = 1e-2 if T < 0.3 else 1e-3
    assert mismatch < gate, "the notebook's core claim (T-scaled gate)"

    # ---- step 5: mass invariance of the rescaled spectrum (tutorial
    # notebook's invariance demo): h(f)/M^2 vs f*M matches across masses
    # (geometric-unit scaling of the quadrupole chirp) ----
    table_all = default_mode_table(8, l_max=2)
    spectra = {}
    for m_scale in (1.0, 2.0):
        pro_s = waveform_prologue(
            M * m_scale, mu * m_scale, p0, e0, theta, phi, 1.0, 0.0, 0.0,
            t_years=T * m_scale, table=table_all, k_max=8, eps=1e-2,
        )
        freq_s = default_frequencies(T * m_scale, dt * m_scale)
        f_pos_s = jnp.asarray(freq_s[freq_s > 0])
        o = fd_waveform_core(pro_s, table_all, f_pos_s, channels=True)
        spectra[m_scale] = (
            np.asarray(f_pos_s) * m_scale,
            (np.asarray(o[0]) + 1j * np.asarray(o[1])) / m_scale**2,
        )
    fM1, h1 = spectra[1.0]
    fM2, h2 = spectra[2.0]
    h2i = np.interp(fM1, fM2, np.abs(h2))
    sel = (np.abs(h1) > np.abs(h1).max() * 1e-3) & (fM1 > fM2[0]) & (fM1 < fM2[-1])
    ratio = h2i[sel] / np.abs(h1)[sel]
    print(
        f"mass invariance |h|/M^2 at fixed f*M: ratio median {np.median(ratio):.4f}"
    )
    assert abs(np.median(ratio) - 1.0) < 0.05

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(2, 1, figsize=(8, 7))
        fsub = np.asarray(f_pos)[band]
        ax[0].semilogy(fsub * 1e3, np.abs(fd_hp_w[band]), label="SPA FD (windowed)")
        ax[0].semilogy(fsub * 1e3, np.abs(fft_hp[band]), "--", label="fft(TD) * dt")
        ax[0].set_xlabel("f [mHz]")
        ax[0].set_ylabel("|h+~|")
        ax[0].legend()
        ax[1].plot(t_knots / 86400.0, f_mode * 1e3)
        ax[1].set_xlabel("t [days]")
        ax[1].set_ylabel("f_22(t) [mHz]")
        fig.tight_layout()
        fig.savefig("fd_construction.png", dpi=110)
        print("wrote fd_construction.png")

    print("OK")


if __name__ == "__main__":
    main()
