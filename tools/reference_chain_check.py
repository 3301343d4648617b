"""External posterior cross-check against the reference's committed chain.

Round-4 VERDICT item 6: every PE validation so far was in-repo (our chain
vs our Fisher). The reference ships its own production posterior —
``samples_GPU.npy`` (5000 x 7; reference ``emri_pe.py:420-422``), the GPU
MCMC for the paper configuration

    -Tobs 4.0 -M 3670041.7362535275 -mu 292.0583167470244
    -p0 13.709101864726545 -e0 0.5794130830706371 -eps 1e-2 -dt 10.0
    -injectFD 1 -template fd -nwalkers 32 -ntemps 2

with injected angles qS = phiS = qK = phiK = pi/3, dist = 2.4539054256 Gpc,
Phi_phi0 = Phi_r0 = pi/3 (reference ``emri_pe.py:595-614``), noiseless
data, PSD = get_sensitivity defaults (sens_fn="lisasens";
``LISAanalysistools/lisatools/sensitivity.py:1289``). Columns:
[lnM, ln(mu/M), p0, e0, Phi_phi0, Phi_r0, logl] — verified here by
recovering each injected value from the column means.

This tool compares the reference chain's marginal widths/centers against
OUR production stack's Cramer-Rao (Fisher) prediction at the SAME
injection — the first validation anchor whose "truth" side was produced
entirely outside this repo (their Teukolsky-flux trajectory + amplitudes
+ sampler). Agreement of sigma_chain(reference) / sigma_Fisher(ours) at
the O(1) level on the intrinsic parameters says the two frameworks put
the same information content in the same source.

Model-mapping caveats (documented, not hidden):
  * our Fisher stencil uses the source-frame (qS, phiS) viewing response
    (tools/pe_validation.py convention) — intrinsic-parameter widths are
    phasing-dominated and insensitive to the response model; the phase
    constants inherit O(1) response-geometry sensitivity;
  * the trajectories differ at the calibration level (our multipole_rwz
    flux vs their Teukolsky grid), so widths may differ at the same level
    the flux models differ (~0.2% in flux; PARITY.md).

Run: PYTHONPATH=. python tools/reference_chain_check.py \
    [--samples /root/reference/samples_GPU.npy] [--downsample 100]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

REF_SAMPLES = "/root/reference/samples_GPU.npy"

# the reference run's injection (emri_pe.py comment line 420 + :595-614)
M_INJ = 3670041.7362535275
MU_INJ = 292.0583167470244
P0_INJ = 13.709101864726545
E0_INJ = 0.5794130830706371
DIST_INJ = 2.4539054256
ANG = np.pi / 3
TOBS, DT, EPS = 4.0, 10.0, 1e-2

LABELS = ["lnM", "ln(mu/M)", "p0", "e0", "Phi_phi0", "Phi_r0"]


def chain_stats(path: str):
    s = np.load(path)
    assert s.shape[1] == 7, s.shape
    params, logl = s[:, :6], s[:, 6]
    return dict(
        sigma=params.std(axis=0),
        mean=params.mean(axis=0),
        logl_max=float(logl.max()),
        logl_med=float(np.median(logl)),
        n=len(s),
    )


def our_fisher(downsample: int, kmax: int, max_steps: int):
    import jax
    import jax.numpy as jnp

    import emri_frequencydomainwaveforms_tpu  # noqa: F401  (x64 config)
    from emri_frequencydomainwaveforms_tpu.lisa.diagnostic import (
        fisher,
        pinv_highprec,
        snr as snr_fn,
    )
    from emri_frequencydomainwaveforms_tpu.lisa.sensitivity import get_sensitivity
    from emri_frequencydomainwaveforms_tpu.models.amplitude import (
        default_mode_table,
    )
    from emri_frequencydomainwaveforms_tpu.models.waveform import (
        default_frequencies,
        fd_waveform_core,
        waveform_prologue,
    )

    table = default_mode_table(30)
    freq = default_frequencies(TOBS, DT)
    f_np = freq[freq > 0][::downsample]
    f_arr = jnp.asarray(f_np)

    @jax.jit
    def _core(p6):
        lm, le, p0_, e0_, pph0, pr0 = p6
        m = jnp.exp(lm)
        mu = m * jnp.exp(le)
        pro = waveform_prologue(
            m, mu, p0_, e0_, ANG, ANG, DIST_INJ, pph0, pr0,
            t_years=TOBS, table=table, k_max=kmax, eps=EPS,
            max_steps=max_steps, flux="multipole_rwz",
            tail=True, factorized=True, rwz=True,
        )
        return fd_waveform_core(pro, table, f_arr, channels=True)

    def wf(params6):
        hpr, hpi, hcr, hci = _core(jnp.asarray(params6))
        return [
            np.asarray(hpr) + 1j * np.asarray(hpi),
            np.asarray(hcr) + 1j * np.asarray(hci),
        ]

    truth = np.array(
        [np.log(M_INJ), np.log(MU_INJ / M_INJ), P0_INJ, E0_INJ, ANG, ANG]
    )
    # reference-run PSD: get_sensitivity defaults (sens_fn="lisasens")
    noise_fn = lambda f: np.asarray(get_sensitivity(np.asarray(f)))
    h_inj = wf(truth)
    snr = float(snr_fn(h_inj, f_arr=f_np, PSD=noise_fn))
    # noise-robust steps (tools/pe_validation.py rationale), scaled to this
    # sharper posterior (4-yr phasing): intrinsic steps ~ the reference
    # chain's own sigmas so the finite difference crosses >> kernel noise
    eps_fd = np.array([2e-6, 6e-6, 2e-5, 1.5e-6, 2.5e-2, 2.5e-2])
    gamma = fisher(wf, truth, eps_fd, f_arr=f_np, PSD=noise_fn)
    cov = pinv_highprec(gamma)
    sig = np.sqrt(np.abs(np.diag(cov)))
    return dict(sigma=sig, snr=snr, cond=float(np.linalg.cond(gamma)),
                truth=truth)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", default=REF_SAMPLES)
    ap.add_argument("--downsample", type=int, default=100)
    ap.add_argument("--kmax", type=int, default=48)
    ap.add_argument("--max-steps", type=int, default=256)
    args = ap.parse_args()

    if not os.path.exists(args.samples):
        raise SystemExit(f"reference chain not found: {args.samples}")

    ref = chain_stats(args.samples)
    ours = our_fisher(args.downsample, args.kmax, args.max_steps)

    truth = ours["truth"]
    print(f"\nreference chain: n={ref['n']}, logl max {ref['logl_max']:.3f} "
          f"med {ref['logl_med']:.3f};  our SNR at injection: {ours['snr']:.1f} "
          f"(Fisher cond {ours['cond']:.2e})")
    print(f"{'param':<10} {'truth':>12} {'ref mean':>12} {'z(ref)':>8} "
          f"{'sigma_ref':>11} {'sigma_F(us)':>11} {'ratio':>7}")
    ratios = []
    for i, lab in enumerate(LABELS):
        z = (ref["mean"][i] - truth[i]) / max(ref["sigma"][i], 1e-300)
        ratio = ref["sigma"][i] / max(ours["sigma"][i], 1e-300)
        ratios.append(ratio)
        print(f"{lab:<10} {truth[i]:>12.6f} {ref['mean'][i]:>12.6f} {z:>8.2f} "
              f"{ref['sigma'][i]:>11.3e} {ours['sigma'][i]:>11.3e} {ratio:>7.2f}")

    report = {
        "snr_ours": ours["snr"],
        "fisher_cond": ours["cond"],
        "sigma_ref_chain": {k: float(v) for k, v in zip(LABELS, ref["sigma"])},
        "sigma_fisher_ours": {k: float(v) for k, v in zip(LABELS, ours["sigma"])},
        "width_ratio_ref_over_fisher": {
            k: float(r) for k, r in zip(LABELS, ratios)
        },
        "ref_logl_max": ref["logl_max"],
    }
    print(json.dumps(report))
    with open("reference_chain_check.json", "w") as fh:
        json.dump(report, fh, indent=1)


if __name__ == "__main__":
    main()
