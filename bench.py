"""Benchmark: all-mode FD waveforms/s on one GPU (1-yr, dt=10s, eps=1e-2).

Prints one JSON line. Configuration matches BASELINE.json: full default
frequency grid of a 1-yr signal at dt=10 s (1.58M positive bins), all-mode
generation at eps=1e-2 through the production path (`waveform_prologue` ->
`fd_waveform_core`, banded windows), vmapped over a walker batch.

Methodology:
* a POSTERIOR-WIDE walker batch (p0/e0/angles jittered ~0.5-5%), each lane
  running its own trajectory and amplitudes on a slot layout frozen from a
  representative source;
* per-batch shared band-window offsets via `band_offsets_for` (the margins
  absorb the batch's band drift) — exactly the production likelihood setup;
* timing: one jitted vmapped batch call, compiled and warmed first (the
  compile is reported as set-up), then timed calls each ended by
  `block_until_ready`;
* ACCURACY GATES (`GATES`) run before timing and zero the score on failure:
  the step budget, mode-power coverage, the banded kernel against the
  independent general sorted-grid kernel, window truncation, a plunging
  source, and the FD/TD Hann-windowed mismatch at the FULL 1-yr
  configuration (both polarization channels).

`chip_smoke.py` runs the same set-up and gates (`setup`, `run_gates`,
`time_batch`) as its generator phase.
"""

import json
import operator
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

T_YEARS, DT = 1.0, 10.0
EPS = 1e-2
# The SCORED physics is the FULL calibrated rung (flux="multipole_rwz",
# tail+factorized+rwz amplitudes — the Teukolsky-equivalent stack), the
# production default: the repo's best physics is the physics the benchmark
# prices. BENCH_PHYS=flat restores the flat-multipole configuration for
# speed comparisons (NOTE: the flat trajectory resolves the plunge fold
# more coarsely, so the plunge gate, calibrated for the rwz default, fails
# there). Gates run identically either way.
PHYS = os.environ.get("BENCH_PHYS", "rwz")
PHYS_KW = (
    dict(flux="multipole_rwz", tail=True, factorized=True, rwz=True)
    if PHYS == "rwz" else {}
)
# eps=1e-2 keeps ~14-15 modes across the posterior-wide batch; 16 slots
# (live set + margin) bound the masked dense work; the coverage gate
# proves the frozen 16-mode set still carries >= (1 - eps) of every lane's
# mode power, and slot 15's widest band (196 runs) + offset margin (32) +
# batch drift (~18) fits the 256-run window
K_MAX = 16
MAX_STEPS = 192  # 1-yr trajectories use ~135 adaptive knots
BATCH = 128
N_TIMED = 5  # timed batch calls after the warm-up
BAND_RUNS = 256  # widest band ~178 runs + offset margin (gate 1 verifies)
BINS_PER_RUN = 64
TURNOVER_SLOTS = 2  # PE-template default: plunge-branch content evaluated
EXTRA_BAND_RUNS = 64  # narrow second-scan budget for the extra slots

# (check name, comparison, threshold): every gate must hold for a score
GATES = (
    ("max_knots", "<=", MAX_STEPS - 4),
    ("min_mode_power_coverage", ">=", 1.0 - 1.25 * EPS),
    ("kernel_xcheck_rel_l2", "<", 1e-4 if PHYS == "flat" else 1e-3),
    ("kernel_xcheck_edge_rel_l2", "<", 0.05),
    ("window_truncation_rel_l2", "<", 1e-3),
    ("plunge_xcheck_rel_l2", "<", 1e-3),
    ("plunge_term_edge_rel_l2", "<", 0.3),
    ("fd_td_hann_mismatch_hp", "<", 1e-4),
    ("fd_td_hann_mismatch_hc", "<", 1e-4),
)


_COMPARE = {"<": operator.lt, "<=": operator.le, ">": operator.gt,
            ">=": operator.ge, "==": operator.eq}


def gate_passes(value, op: str, threshold) -> bool:
    """One gate; a NaN value fails every comparison."""
    return bool(_COMPARE[op](value, threshold))


def _split_rel_l2(full4, sub4, sub, is_edge):
    """Worst rel-L2 of the four outputs of a full-grid kernel (sampled at
    ``sub``) against a kernel run on ``sub`` alone, over the non-edge and
    the edge bins separately (0.0 where there are no edge bins)."""
    non, edge = [], [0.0]
    for b_full, g_sub in zip(full4, sub4):
        b_sub = np.asarray(b_full)[sub]
        err = (b_sub - np.asarray(g_sub)) / (np.sqrt(np.mean(b_sub**2)) + 1e-300)
        non.append(np.sqrt(np.mean(err[~is_edge] ** 2)))
        if is_edge.any():
            edge.append(np.sqrt(np.mean(err[is_edge] ** 2)))
    return float(np.max(non)), float(np.max(edge))


def _mismatch(a, b):
    num = np.abs(np.vdot(a, b))
    den = np.sqrt(np.vdot(a, a).real * np.vdot(b, b).real)
    return float(1.0 - num / den)


def _stage(msg: str) -> None:
    """Opt-in progress logging (BENCH_VERBOSE=1): a cold run spends
    minutes in compiles with no output, which reads as a hang."""
    if os.environ.get("BENCH_VERBOSE"):
        print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}",
              file=sys.stderr, flush=True)


_T0 = time.perf_counter()


def device_info() -> dict:
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def require_gpu() -> dict:
    """Device identity of a GPU run; exits non-zero on any other platform
    (a CPU timing is never reported under a device metric)."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {info['platform']} "
            f"({info['kind']}); this measurement runs only on a GPU"
        )
    return info


def setup() -> SimpleNamespace:
    """Tables, grid, frozen slot layout, shared band windows, the walker
    batch and the per-lane generator `gen(p0, e0, theta, phi)`."""
    import emri_frequencydomainwaveforms_tpu  # noqa: F401  (x64 config)
    import jax
    import jax.numpy as jnp
    from emri_frequencydomainwaveforms_tpu.models.amplitude import default_mode_table
    from emri_frequencydomainwaveforms_tpu.models.waveform import (
        band_offsets_for,
        default_frequencies,
        fd_waveform_core,
        waveform_prologue,
    )

    table = default_mode_table(30)
    freq = default_frequencies(T_YEARS, DT)
    f_np = freq[freq > 0]
    f_arr = jnp.asarray(f_np)
    f0u, dfu = float(f_np[0]), float(f_np[1] - f_np[0])
    uniform = (f0u, dfu)

    # Slot layout frozen from a representative source: the shared band
    # windows need slot k to mean the SAME physical mode on every lane, and
    # per-lane eps selection breaks that whenever a marginal mode crosses
    # the eps boundary (every later slot shifts by one — caught by gate 1
    # when first tried). Per-lane amplitudes/phases still vary; the
    # coverage gate PROVES the frozen set covers >= (1 - eps) of every
    # lane's mode power, which is the eps semantic the metric claims.
    # Jitted even for this one-shot call: the rwz prologue traces to ~2000
    # ops, far too many to dispatch one by one.
    pro_sel = jax.jit(
        lambda: waveform_prologue(
            1e6, 10.0, 12.0, 0.35, 0.7, 0.5, 1.0, 0.0, 0.0,
            t_years=T_YEARS, table=table, k_max=K_MAX, eps=EPS,
            max_steps=MAX_STEPS, **PHYS_KW,
        )
    )()
    _stage("mode-selection prologue done")
    forced_idx = np.asarray(pro_sel.sel.idx)
    # production fast path: the table is SLICED to the frozen selection so
    # the prologue evaluates amplitudes only for the kept modes; the
    # coverage gate still scores against the FULL candidate table
    table_k = table.take(forced_idx)
    idx_k = np.arange(len(forced_idx))

    def prologue(p0, e0, th, ph):
        return waveform_prologue(
            1e6, 10.0, p0, e0, th, ph, 1.0, 0.0, 0.0,
            t_years=T_YEARS, table=table_k, k_max=K_MAX, eps=EPS,
            max_steps=MAX_STEPS, forced_idx=idx_k, **PHYS_KW,
        )

    # shared band windows from the same representative source
    pro0 = jax.jit(prologue)(12.0, 0.35, 0.7, 0.5)
    _stage("representative prologue done")
    offsets_j = jnp.asarray(
        band_offsets_for(pro0, table_k, f0u, dfu, BINS_PER_RUN, BAND_RUNS)
    )

    # shared extra-slot window offsets: the batch has no live turnover
    # modes (chirp regime), so the extra slots are dead weight priced into
    # the score — the metric reflects the PE-default configuration
    offsets_extra = jnp.zeros((TURNOVER_SLOTS,), jnp.int32)

    def gen(p0, e0, th, ph):
        pro = prologue(p0, e0, th, ph)
        return fd_waveform_core(
            pro, table_k, f_arr, channels=True, uniform=uniform,
            band_runs=BAND_RUNS, band_offsets=offsets_j,
            bins_per_run=BINS_PER_RUN, turnover_slots=TURNOVER_SLOTS,
            extra_band_runs=EXTRA_BAND_RUNS, band_offsets_extra=offsets_extra,
            out_f32=True,
        )

    # posterior-wide walker batch
    rng = np.random.default_rng(7)
    batch = tuple(
        jnp.asarray(c + w * (rng.random(BATCH) - 0.5))
        for c, w in ((12.0, 0.12), (0.35, 0.03), (0.7, 0.2), (0.5, 0.2))
    )
    return SimpleNamespace(
        table=table, table_k=table_k, forced_idx=forced_idx, freq=freq,
        f_np=f_np, f_arr=f_arr, f0u=f0u, dfu=dfu, uniform=uniform,
        prologue=prologue, gen=gen, batch=batch,
    )


def run_gates(b: SimpleNamespace) -> dict:
    """Every accuracy gate of `GATES`, on the default device; returns the
    checks (gate values and the statistics reported beside them)."""
    import jax
    import jax.numpy as jnp
    from emri_frequencydomainwaveforms_tpu.models.waveform import (
        _assemble_channels,
        default_time_grid,
        fd_waveform_core,
        td_waveform_core,
        waveform_prologue,
    )
    from emri_frequencydomainwaveforms_tpu.utils.fdutils import (
        get_fd_windowed,
        get_fft_td_windowed,
    )

    table, table_k, f_np, f_arr = b.table, b.table_k, b.f_np, b.f_arr
    nf = len(f_np)
    p0s, e0s, ths, phs = b.batch
    checks: dict = {}

    # ---- gate 0: trajectory step budget covers every lane ----
    n_live = jax.jit(
        jax.vmap(lambda p0, e0: waveform_prologue(
            1e6, 10.0, p0, e0, 0.7, 0.5, 1.0, 0.0, 0.0,
            t_years=T_YEARS, table=table, k_max=8, eps=0.5,
            max_steps=MAX_STEPS, **PHYS_KW,
        ).n_live)
    )(p0s, e0s)
    _stage("gate 0 (step budget) done")
    checks["max_knots"] = int(jnp.max(n_live))

    # ---- gate 1b: frozen mode set covers every lane's eps power ----
    from emri_frequencydomainwaveforms_tpu.models.amplitude import mode_amplitudes
    from emri_frequencydomainwaveforms_tpu.models.modeselect import mode_power
    from emri_frequencydomainwaveforms_tpu.models.inspiral import (
        schwarz_ecc_flux_inspiral,
    )
    from emri_frequencydomainwaveforms_tpu.utils.ylm import spin_weighted_ylm

    @jax.jit
    @jax.vmap
    def coverage(p0, e0, th, ph):
        traj = schwarz_ecc_flux_inspiral(
            1e6, 10.0, p0, e0, t_years=T_YEARS, max_steps=MAX_STEPS,
            flux=PHYS_KW.get("flux", "pm"),
        )
        a_re, a_im = mode_amplitudes(
            traj.p, traj.e, table,
            **{k: v for k, v in PHYS_KW.items() if k != "flux"},
        )
        yp = spin_weighted_ylm(table.ls, table.ms, th, ph)
        ym = spin_weighted_ylm(table.ls, -table.ms, th, ph)
        live = (jnp.arange(traj.t.shape[0]) < traj.n).astype(traj.t.dtype)
        power = mode_power(a_re, a_im, yp[0], yp[1], ym[0], ym[1], dt_weights=live)
        kept = jnp.sum(jnp.take(power, jnp.asarray(b.forced_idx)))
        return kept / jnp.sum(power)

    cov = np.asarray(coverage(p0s, e0s, ths, phs))
    _stage("gate 1b (coverage) done")
    checks["min_mode_power_coverage"] = float(cov.min())

    # ---- gate 1: banded kernel vs the general sorted-grid kernel ----
    # compared over the WHOLE grid including band edges: the banded
    # kernel's edge intervals carry exact-anchor affine envelopes
    # (summation_fd._level1_uniform_tables), so no exclusion zone is
    # needed — any edge regression trips the gate directly
    sub = np.arange(0, nf, 617)
    pro_l0 = jax.jit(b.prologue)(p0s[0], e0s[0], ths[0], phs[0])
    banded = jax.jit(b.gen)(p0s[0], e0s[0], ths[0], phs[0])
    # full-window banded evaluation: same kernel, band windows disabled —
    # isolates kernel correctness from the production window budget
    banded_fw = jax.jit(
        lambda pro: fd_waveform_core(
            pro, table_k, f_arr, channels=True, uniform=b.uniform,
            bins_per_run=BINS_PER_RUN, turnover_slots=TURNOVER_SLOTS,
        )
    )(pro_l0)
    general = jax.jit(
        lambda pro: fd_waveform_core(
            pro, table_k, f_arr[jnp.asarray(sub)], channels=True,
            turnover_slots=TURNOVER_SLOTS,
        )
    )(pro_l0)

    _stage("gate 1 (banded vs general) waveforms done")
    checks["xcheck_bins"] = int(len(sub))

    # worst of the four real outputs; np.max keeps a NaN (Python's max
    # would drop it and let a broken output pass its gate)
    def _rel_l2(a4, b4, idx=None):
        errs = []
        for x, y in zip(a4, b4):
            x = np.asarray(x)
            y = np.asarray(y)
            if idx is not None:
                x = x[idx]
            if len(x) != len(y):
                y = y[idx]
            scale = np.sqrt(np.mean(x**2)) + 1e-300
            errs.append(np.sqrt(np.mean((x - y) ** 2)) / scale)
        return float(np.max(errs))

    from emri_frequencydomainwaveforms_tpu.ops.cubic_spline import (
        fit_cubic_spline as _fit_cs,
        spline_eval as _spl_ev,
    )

    def _band_edge_mask(pro, tbl, f_at, edge_runs=2.0):
        """True where f_at lies within ``edge_runs`` 64-bin runs of a live
        mode band's start/termination. At band TERMINATIONS (trajectory
        end — Tobs cutoff or plunge) the envelope is cut off mid-flight
        and the banded kernel's level-1 nodes anchor against extrapolated
        t(f) while the general kernel reads the time spline directly —
        a localized, documented disagreement (absolute accuracy there is
        bounded by the FD/TD gate and tests/test_real_fold.py)."""
        sp_pp = _fit_cs(pro.t_knots, pro.phi_phi, bc="not-a-knot")
        sp_pr = _fit_cs(pro.t_knots, pro.phi_r, bc="not-a-knot")
        fphi_k = np.asarray(_spl_ev(sp_pp, pro.t_knots, deriv=1)) / (2 * np.pi)
        fr_k = np.asarray(_spl_ev(sp_pr, pro.t_knots, deriv=1)) / (2 * np.pi)
        sel_i = np.asarray(pro.sel.idx)
        live_m = np.asarray(pro.sel.mask).astype(bool)
        nl = int(pro.n_live)
        fk = (
            tbl.ms[sel_i].astype(float)[:, None] * fphi_k[None, :nl]
            + tbl.ns[sel_i].astype(float)[:, None] * fr_k[None, :nl]
        )
        edges = np.concatenate(
            [fk[live_m][:, 0], fk[live_m][:, -1], fk[live_m].max(axis=1)]
        )
        d = np.min(np.abs(f_at[:, None] - edges[None, :]), axis=1)
        return d < edge_runs * BINS_PER_RUN * b.dfu

    # (1) KERNEL equivalence: full-window banded vs general sorted-grid —
    # the same spectrum through two independent evaluation orders. Each
    # kernel matches its own CPU-f64 execution to ~7e-7 (the exact phase
    # pipeline — f64 Horner in the general kernel, integer-cycle split in
    # the banded one), and the remaining banded-vs-general ~6e-4 is
    # DETERMINISTIC interpolation: the omega-dependent rwz/tail rotation
    # makes the complex envelope rotate along each band, and the banded
    # kernel's per-run Catmull-Rom vs the general kernel's node-linear
    # envelope resolve that rotation differently (flat physics, envelope
    # non-rotating: 5e-6). The gate sits at that floor until the
    # structural fix (absorb arg(A) into the per-mode phase spline).
    # Band-edge bins (termination anchoring, see _band_edge_mask) are
    # reported separately.
    is_edge1 = _band_edge_mask(pro_l0, table_k, f_np[sub])
    xerr = _rel_l2(banded_fw, general, idx=sub)  # full stat, reported
    checks["kernel_xcheck_rel_l2"], checks["kernel_xcheck_edge_rel_l2"] = (
        _split_rel_l2(banded_fw, general, sub, is_edge1)
    )
    checks["kernel_xcheck_incl_edges_rel_l2"] = xerr
    checks["kernel_xcheck_edge_bins"] = int(is_edge1.sum())
    # (2) WINDOW truncation: production banded windows (BAND_RUNS +
    # offsets + extra slots) vs the full-window evaluation — the spectral
    # content the frozen 256-run band budget drops, an accuracy KNOB like
    # eps (sized by freeze_mode_selection's drift margins), not a kernel
    # property. Expected 0.0 at the bench config (the 256-run windows
    # carry every band in full); budget 1e-3.
    checks["window_truncation_rel_l2"] = _rel_l2(banded, banded_fw, idx=sub)

    # ---- gate 1c: plunging source through the banded production path ----
    # near-separatrix source (plunges at ~0.03 yr): the banded kernel must
    # carry the post-turnover branch content and agree with the general
    # kernel to the fold-resolution limit (see summation_fd docstring: the
    # uniform-in-f node grid leaves percent-level errors within ~1 run of
    # the fold, inside the SPA's own validity limit there)
    pro_pl = jax.jit(
        lambda: waveform_prologue(
            1e6, 50.0, 7.6, 0.3, 0.7, 0.5, 1.0, 0.0, 0.0,
            t_years=T_YEARS, table=table, k_max=K_MAX, eps=EPS,
            max_steps=MAX_STEPS, **PHYS_KW,
        )
    )()
    sub_pl = np.arange(0, nf, 1043)
    banded_pl = jax.jit(
        lambda pro: fd_waveform_core(
            pro, table, f_arr, channels=True, uniform=b.uniform,
            bins_per_run=BINS_PER_RUN, turnover_slots=TURNOVER_SLOTS,
            extra_band_runs=None,
        )
    )(pro_pl)
    general_pl = jax.jit(
        lambda pro: fd_waveform_core(
            pro, table, f_arr[jnp.asarray(sub_pl)], channels=True,
            turnover_slots=TURNOVER_SLOTS,
        )
    )(pro_pl)
    _stage("gate 1c (plunge) waveforms done")
    # Split the statistic by band-TERMINATION proximity: at a plunging
    # source every mode's spectrum is cut off mid-flight at the trajectory
    # end, and within the final ~1 run (64 bins) of a band the banded
    # kernel's level-1 nodes anchor against extrapolated t(f) while the
    # general kernel evaluates the time spline directly — percent-level on
    # the strongest band's termination bin (a bin-level survey found ONE
    # bin at the (2,2,1) termination carrying 99.9% of the squared error;
    # fold bins read ~1e-5, the turnover slots resolve them). Absolute
    # accuracy at the termination is separately bounded by the FD/TD
    # mismatch gate and the brute-force oscillatory-integral check
    # (tests/test_real_fold.py). Away from terminations the kernels must
    # agree at the kernel-equivalence level.
    is_term = _band_edge_mask(pro_pl, table, f_np[sub_pl])
    checks["plunge_xcheck_rel_l2"], checks["plunge_term_edge_rel_l2"] = (
        _split_rel_l2(banded_pl, general_pl, sub_pl, is_term)
    )
    checks["plunge_term_edge_bins"] = int(is_term.sum())

    # ---- gate 2: FD/TD Hann mismatch at the full 1-yr config ----
    t_grid = jnp.asarray(default_time_grid(T_YEARS, DT))
    hp_td, hc_td = jax.jit(lambda pro: td_waveform_core(pro, table_k, t_grid))(pro_l0)
    hp_td, hc_td = np.asarray(hp_td), np.asarray(hc_td)
    hp_fd_pos = np.asarray(banded[0]) + 1j * np.asarray(banded[1])
    hc_fd_pos = np.asarray(banded[2]) + 1j * np.asarray(banded[3])
    hp_fd, hc_fd = _assemble_channels(b.freq, hp_fd_pos, hc_fd_pos, True)
    _stage("gate 2 (FD/TD) waveforms done")
    w = np.hanning(len(hp_td))
    fd_w = get_fd_windowed([hp_fd, hc_fd], w)
    td_w = get_fft_td_windowed([hp_td, hc_td], w, DT)
    pos = b.freq >= 0
    checks["fd_td_hann_mismatch_hp"] = _mismatch(fd_w[0][pos], td_w[0][pos])
    checks["fd_td_hann_mismatch_hc"] = _mismatch(fd_w[1][pos], td_w[1][pos])
    return checks


def time_batch(b: SimpleNamespace, n_timed: int = N_TIMED) -> dict:
    """Compile, warm and time the vmapped batch generator; returns the
    compile time, the per-call wall times and whether every output of the
    last call is finite."""
    import jax
    import jax.numpy as jnp

    batch_fn = jax.jit(jax.vmap(b.gen))
    t0 = time.perf_counter()
    out = jax.block_until_ready(batch_fn(*b.batch))
    compile_s = time.perf_counter() - t0  # includes the first execution
    _stage("batch generator compiled + warm")
    walls = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        out = jax.block_until_ready(batch_fn(*b.batch))
        walls.append(time.perf_counter() - t0)
    finite = jax.jit(lambda o: jnp.all(jnp.stack([jnp.isfinite(x).all() for x in o])))
    return {
        "compile_s": compile_s,
        "wall_s": walls,
        "finite": bool(finite(out)),
        "shapes": [tuple(o.shape) for o in out],
    }


def main() -> None:
    from emri_frequencydomainwaveforms_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    device = require_gpu()
    b = setup()
    checks = run_gates(b)
    timing = time_batch(b)
    checks["finite"] = timing["finite"]
    ok = timing["finite"] and all(
        gate_passes(checks[name], op, thr) for name, op, thr in GATES
    )
    wf_per_sec = BATCH * len(timing["wall_s"]) / sum(timing["wall_s"])
    print(
        json.dumps(
            {
                "metric": "all-mode FD waveforms/sec (1yr, dt=10s, eps=1e-2, full grid)",
                "value": wf_per_sec if ok else 0.0,
                "unit": "waveforms/s",
                "physics": PHYS,
                "device": device,
                "batch": BATCH,
                "compile_s": timing["compile_s"],
                "wall_s": timing["wall_s"],
                "checks": checks,
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
