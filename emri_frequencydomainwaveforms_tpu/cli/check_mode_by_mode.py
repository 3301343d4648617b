"""TD-vs-FD accuracy and timing scan (the reference's benchmark suite).

Rebuilds ``check_mode_by_mode.py`` (flow pinned at reference
``check_mode_by_mode.py``: random prior draws :183-185; duration-fixing
``get_p_at_t`` :201-213; FD full / FD downsampled / TD timing :222-259;
windowed mismatches for [boxcar, blackman, hann, nuttall] :264-309; residual
log-likelihoods :312-326; failed-point recording :328-330; HDF5 outputs
{T, dt, eps, mismatch, failed_points, list_injections, timing_td, timing_fd,
loglike, SNR} :332-358). The outputs are written with ``numpy.savez``
under the same names, the per-window mismatches as ``mismatch_<window>``.

    python -m emri_frequencydomainwaveforms_tpu.cli.check_mode_by_mode \
        -Tobs 0.1 -nsteps 3 -dt 10 -eps 1e-2 -outname scan.npz
"""

from __future__ import annotations

import argparse
import time

import numpy as np

WINDOWS = ["boxcar", "blackman", "hann", "nuttall"]


def build_parser():
    p = argparse.ArgumentParser(description="TD-vs-FD scan (check_mode_by_mode parity)")
    p.add_argument("-Tobs", "--Tobs", type=float, default=0.1)
    p.add_argument("-dt", "--dt", type=float, default=10.0)
    p.add_argument("-eps", "--eps", type=float, default=1e-2)
    p.add_argument("-nsteps", "--nsteps", type=int, default=3, help="number of random draws")
    p.add_argument("-dev", "--dev", type=int, default=0)
    p.add_argument("-downsample", "--downsample", type=int, default=100)
    p.add_argument("-random_modes", "--random_modes", type=int, default=0,
                   help="draw one random (l,m,n) mode per point instead of eps-selection")
    p.add_argument("-outname", "--outname", type=str, default="check_mode_by_mode.npz")
    p.add_argument("--seed", type=int, default=2601996)
    p.add_argument("-turnover_slots", "--turnover_slots", type=int, default=2,
                   help="extra FD kernel slots for post-turnover branches "
                        "(default matches the PE-template/facade default)")
    p.add_argument("-negative_slots", "--negative_slots", type=int, default=0,
                   help="extra FD kernel slots for negative-frequency ranges")
    p.add_argument("-flux", "--flux", type=str, default="multipole_rwz",
                   choices=["pm", "multipole", "multipole_tail",
                            "multipole_factorized", "multipole_rwz"],
                   help="trajectory dissipation model (default: the "
                        "calibrated RWZ stack — production physics)")
    p.add_argument("-amp", "--amp", type=str, default="rwz",
                   choices=["flat", "tail", "factorized", "rwz"],
                   help="amplitude physics: flat-space multipoles, + wave-"
                        "tail factor, + full factorized resummation "
                        "(source/rho/delta; models.rho), + RWZ strong-"
                        "field calibration (models.rwz_calibration; "
                        "default)")
    return p


def run_check(args) -> dict:
    import emri_frequencydomainwaveforms_tpu  # noqa: F401
    import jax

    from ..inference.prior import ProbDistContainer, uniform_dist
    from ..lisa.diagnostic import inner_product, snr
    from ..lisa.sensitivity import get_sensitivity
    from ..models.inspiral import get_p_at_t
    from ..models.waveform import GenerateEMRIWaveform
    from ..utils.fdutils import get_fd_windowed, get_fft_td_windowed
    from ..utils import windows as win_mod

    rng = np.random.default_rng(args.seed)
    priors = ProbDistContainer(
        {
            0: uniform_dist(np.log(5e5), np.log(4e6)),
            1: uniform_dist(np.log(1e-5), np.log(1e-4)),
            2: uniform_dist(0.1, 0.5),  # e0
        }
    )

    amp_kwargs = dict(
        tail=args.amp in ("tail", "factorized", "rwz"),
        factorized=args.amp in ("factorized", "rwz"),
        rwz=args.amp == "rwz",
    )
    td_gen = GenerateEMRIWaveform(
        sum_kwargs=dict(odd_len=True, flux=args.flux),
        amplitude_kwargs=amp_kwargs, return_list=True
    )
    fd_gen = GenerateEMRIWaveform(
        sum_kwargs=dict(
            output_type="fd", odd_len=True, flux=args.flux,
            turnover_slots=args.turnover_slots,
            negative_slots=args.negative_slots,
        ), amplitude_kwargs=amp_kwargs, return_list=True
    )
    noise = lambda f: np.asarray(
        get_sensitivity(np.asarray(f), sens_fn="cornish_lisa_psd")
    )

    results = {
        "T": args.Tobs,
        "dt": args.dt,
        "eps": args.eps,
        "list_injections": [],
        "timing_td": [],
        "timing_fd": [],
        "timing_fd_downsampled": [],
        "mismatch": {w: [] for w in WINDOWS},
        "SNR": [],
        "loglike": [],
        "failed_points": [],
    }

    mode_pool = [(2, 2, n) for n in range(-3, 6)] + [(2, 0, n) for n in range(1, 4)]

    for step in range(args.nsteps):
        draw = priors.rvs(size=1, random_state=rng)[0]
        m_central = float(np.exp(draw[0]))
        mu = float(np.exp(draw[0]) * np.exp(draw[1]))
        e0 = float(draw[2])
        try:
            p0 = float(get_p_at_t(m_central, mu, e0, 0.99 * args.Tobs,
                                  flux=args.flux))
            pars = [m_central, mu, 0.0, p0, e0, 1.0, 1.0,
                    np.pi / 4, np.pi / 3, np.pi / 5, np.pi / 6, 1.0, 0.0, 2.0]
            kw = dict(T=args.Tobs, dt=args.dt)
            if args.random_modes:
                kw["mode_selection"] = [mode_pool[rng.integers(len(mode_pool))]]
            else:
                kw["eps"] = args.eps

            tic = time.perf_counter()
            hfd = fd_gen(*pars, **kw)
            t_fd = time.perf_counter() - tic

            freq = fd_gen.frequency
            pos = freq > 0
            f_ds = freq[pos][:: max(args.downsample, 1)]
            tic = time.perf_counter()
            _ = fd_gen(*pars, f_arr=f_ds, **kw)
            t_fd_ds = time.perf_counter() - tic

            tic = time.perf_counter()
            htd = td_gen(*pars, **kw)
            t_td = time.perf_counter() - tic

            n = len(htd[0])
            f_all = freq
            fpos_mask = f_all >= 0
            f_pos_arr = f_all[fpos_mask]
            psd_ok = f_pos_arr > 1e-5  # keep out of the PSD's flushed corner
            snr_val = snr(
                [c[fpos_mask][psd_ok] for c in hfd],
                f_arr=f_pos_arr[psd_ok],
                PSD=noise,
            )
            results["SNR"].append(float(snr_val))

            for wname in WINDOWS:
                w = np.asarray(win_mod.WINDOWS[wname](n))
                fd_w = get_fd_windowed(hfd, w)
                td_w = get_fft_td_windowed(htd, w, args.dt)
                mism = []
                for a, b in zip(fd_w, td_w):
                    av, bv = a[fpos_mask], b[fpos_mask]
                    num = np.abs(np.vdot(av, bv))
                    den = np.sqrt(np.vdot(av, av).real * np.vdot(bv, bv).real)
                    mism.append(1.0 - num / den)
                results["mismatch"][wname].append(float(np.mean(mism)))

            # residual log-likelihood -1/2 <fd - td, fd - td>
            fd_p = [c[fpos_mask][psd_ok] for c in get_fd_windowed(hfd, np.asarray(win_mod.hann(n)))]
            td_p = [c[fpos_mask][psd_ok] for c in get_fft_td_windowed(htd, np.asarray(win_mod.hann(n)), args.dt)]
            diff = [a - b for a, b in zip(fd_p, td_p)]
            ll = -0.5 * inner_product(diff, diff, f_arr=f_pos_arr[psd_ok], PSD=noise)
            results["loglike"].append(float(ll))

            results["list_injections"].append(pars)
            results["timing_fd"].append(t_fd)
            results["timing_fd_downsampled"].append(t_fd_ds)
            results["timing_td"].append(t_td)
            print(
                f"[{step}] M={m_central:.2e} mu={mu:.1f} e0={e0:.2f} p0={p0:.2f} "
                f"SNR={snr_val:.1f} hann-mism={results['mismatch']['hann'][-1]:.2e} "
                f"t_fd={t_fd:.2f}s t_td={t_td:.2f}s speedup={t_td / t_fd:.1f}x"
            )
        except Exception as exc:  # record, keep scanning (reference :328-330)
            print(f"[{step}] FAILED: {exc}")
            results["failed_points"].append([float(draw[0]), float(draw[1]), float(draw[2])])

    _save_npz(args.outname, results)
    return results


def _save_npz(path: str, results: dict) -> None:
    arrays = {
        key: np.asarray(results[key], dtype=np.float64)
        for key in (
            "T",
            "dt",
            "eps",
            "list_injections",
            "timing_td",
            "timing_fd",
            "timing_fd_downsampled",
            "SNR",
            "loglike",
            "failed_points",
        )
    }
    for wname, vals in results["mismatch"].items():
        arrays[f"mismatch_{wname}"] = np.asarray(vals, dtype=np.float64)
    np.savez(path, **arrays)
    print(f"scan written to {path}")


def main(argv=None) -> dict:
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    args = build_parser().parse_args(argv)
    return run_check(args)


if __name__ == "__main__":
    main()
