"""Bring-up smoke test: the main paths on one NVIDIA GPU, checked.

Run from the repository root on a machine with one GPU:

    python chip_smoke.py

One process holds the card; the CLIs are called in it through their
``main(argv)``. Phases, in order (any failure exits non-zero before the
final line):

0. device: the card's name and power limit from ``nvidia-smi``; JAX's first
   device must be a GPU (no fallback to the CPU).
1. generator at full width: the ``bench.py`` configuration (1 yr at
   dt = 10 s on the full 1.58M-bin grid, rwz physics, eps = 1e-2, banded
   windows, a vmapped batch of 128 through ``waveform_prologue`` ->
   ``fd_waveform_core``), all of ``bench.py``'s accuracy gates, and lane 0
   on the GPU against the same call on the host CPU backend.
2. parameter estimation through ``cli.emri_pe``: an FD-template chain at
   1 yr, and a short TD-template run whose spectrum is compared with
   ``numpy.fft.rfft`` of the same TD waveform.
3. the TD-vs-FD scan through ``cli.check_mode_by_mode``.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import tempfile
import time

import numpy as np

import bench

# GPU vs host-CPU lane-0 agreement of the banded generator. Each kernel
# matches a CPU f64 run of itself to ~7e-7; the dense pass is f32 sincos of
# mod-2pi-reduced phases summed over 16 slots, so 1e-5 leaves room for a
# different summation order and libdevice transcendentals, and still
# catches a TF32 contraction (~1e-3).
GPU_CPU_REL_L2 = 1e-5
# the TD-template spectrum and numpy's rfft are both f64
TD_SPECTRUM_REL_L2 = 1e-10
# |logL| at the injected truth (tests/test_pe_end_to_end.py)
TRUTH_LOGL = 1e-3
DOWNSAMPLE = 100
FD_TOBS, TD_TOBS, SCAN_TOBS = 1.0, 0.1, 1.0  # observation times [yr]
PE_ARGS = ["-M", "1e6", "-mu", "10", "-e0", "0.35", "-dt", str(bench.DT),
           "-injectFD", "1", "-downsample", str(DOWNSAMPLE),
           "-nwalkers", "16", "-ntemps", "2"]


def say(msg: str) -> None:
    print(msg, flush=True)


class CompileClock:
    """Seconds XLA spent compiling (or fetching from the persistent cache),
    summed from JAX's monitoring events."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.seconds = 0.0
        self.count = 0

    def __call__(self, event, duration, **_):
        if event == self.EVENT:
            self.seconds += duration
            self.count += 1


class Phase:
    """Times one phase and collects its comparisons; a failed comparison
    ends the run when the phase closes."""

    def __init__(self, name: str, clock: CompileClock):
        self.name, self.clock = name, clock
        self.failed = []

    def __enter__(self):
        say(f"== phase {self.name}")
        self.t0, self.c0, self.n0 = time.perf_counter(), self.clock.seconds, self.clock.count
        return self

    def check(self, label: str, value, op: str, threshold) -> None:
        ok = bench.gate_passes(value, op, threshold)
        say(f"  {label}: {value!r} {op} {threshold!r}  {'ok' if ok else 'FAILED'}")
        if not ok:
            self.failed.append(label)

    def __exit__(self, exc_type, *_):
        if exc_type is not None:
            return False
        say(f"  phase {self.name}: wall {time.perf_counter() - self.t0:.3f} s, "
            f"compile {self.clock.seconds - self.c0:.3f} s "
            f"({self.clock.count - self.n0} programs)")
        if self.failed:
            raise SystemExit(f"phase {self.name} failed: {', '.join(self.failed)}")
        return False


def rel_l2(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def phase_device() -> dict:
    device = bench.require_gpu()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    say(smi.stdout.strip())
    say(f"  jax device: {device}")
    return device


def phase_generator(ph: Phase) -> None:
    import jax
    from emri_frequencydomainwaveforms_tpu.models.flux import default_flux_grid

    t0 = time.perf_counter()
    default_flux_grid(tail=True, factorized=True, rwz=True)
    say(f"  set-up: rwz flux grid build {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    b = bench.setup()
    say(f"  set-up: slot layout + band windows {time.perf_counter() - t0:.3f} s")

    timing = bench.time_batch(b)
    walls = timing["wall_s"]
    say(f"  batch {bench.BATCH}: first call (compile + run) {timing['compile_s']:.3f} s; "
        f"timed calls {', '.join(f'{w:.4f}' for w in walls)} s "
        f"-> {bench.BATCH * len(walls) / sum(walls):.1f} waveforms/s")
    nf = len(b.f_np)
    ph.check("batch output shapes", timing["shapes"], "==", [(bench.BATCH, nf)] * 4)
    ph.check("batch outputs finite", timing["finite"], "==", True)

    t0 = time.perf_counter()
    checks = bench.run_gates(b)
    say(f"  gates computed in {time.perf_counter() - t0:.3f} s")
    for name, op, threshold in bench.GATES:
        ph.check(name, checks[name], op, threshold)
    for name in ("kernel_xcheck_incl_edges_rel_l2", "kernel_xcheck_edge_bins",
                 "plunge_term_edge_bins", "xcheck_bins"):
        say(f"  {name}: {checks[name]!r}")

    # lane 0 on the GPU against the same call on the host CPU backend
    lane0 = [x[0] for x in b.batch]
    gpu_out = jax.jit(b.gen)(*lane0)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        cpu_out = jax.jit(b.gen)(*(jax.device_put(x, cpu) for x in lane0))
    worst = 0.0
    for k in (0, 2):  # h+ and hx as complex channels
        g = np.asarray(gpu_out[k], np.float64) + 1j * np.asarray(gpu_out[k + 1], np.float64)
        c = np.asarray(cpu_out[k], np.float64) + 1j * np.asarray(cpu_out[k + 1], np.float64)
        worst = max(worst, rel_l2(g, c))
    ph.check("lane 0 GPU vs host CPU rel-L2", worst, "<=", GPU_CPU_REL_L2)


def phase_pe(ph: Phase, tmp: str) -> None:
    import jax
    import jax.numpy as jnp
    from emri_frequencydomainwaveforms_tpu.cli import emri_pe

    t0 = time.perf_counter()
    res = emri_pe.main(["-Tobs", str(FD_TOBS), "-template", "fd", "-nsteps", "5",
                        *PE_ARGS, "--outname", f"{tmp}/pe_fd.npz"])
    say(f"  FD chain ({FD_TOBS} yr, 5 steps x 2x16 walkers): "
        f"{time.perf_counter() - t0:.3f} s")
    chain = np.asarray(res["chain"])
    ph.check("FD chain finite", bool(np.isfinite(chain).all()), "==", True)
    acc = float(np.mean(res["sampler"].acceptance_fraction))
    ph.check("FD chain acceptance", acc, ">", 0.0)
    ll = float(res["likelihood"](jnp.asarray(res["truth"][None]))[0])
    ph.check("|logL| at the injected truth", abs(ll), "<", TRUTH_LOGL)

    t0 = time.perf_counter()
    res = emri_pe.main(["-Tobs", str(TD_TOBS), "-template", "td", "-nsteps", "2",
                        *PE_ARGS, "--outname", f"{tmp}/pe_td.npz"])
    say(f"  TD run ({TD_TOBS} yr, 2 steps): {time.perf_counter() - t0:.3f} s")
    ph.check("TD chain finite", bool(np.isfinite(np.asarray(res["chain"])).all()), "==", True)
    hp_hc = jax.jit(res["td_channels"])(jnp.asarray(res["injection"]))
    n_t = len(hp_hc[0])
    idx = np.arange(1, (n_t + 1) // 2)[::DOWNSAMPLE]
    worst = max(
        rel_l2(got, np.fft.rfft(np.asarray(h))[idx] * bench.DT)
        for got, h in zip(res["data"], hp_hc)
    )
    ph.check("TD spectrum vs numpy rfft rel-L2", worst, "<=", TD_SPECTRUM_REL_L2)


def phase_scan(ph: Phase, tmp: str) -> None:
    from emri_frequencydomainwaveforms_tpu.cli import check_mode_by_mode

    res = check_mode_by_mode.main(["-Tobs", str(SCAN_TOBS), "-nsteps", "2",
                                   "-outname", f"{tmp}/scan.npz"])
    say(f"  hann mismatches: {res['mismatch']['hann']}")
    ph.check("scan points", len(res["list_injections"]), ">=", 2)
    ph.check("scan failed points", res["failed_points"], "==", [])


def main() -> None:
    import jax
    from emri_frequencydomainwaveforms_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    say(f"compile cache: {enable_compile_cache()}")
    clock = CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock)
    device = phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("1 generator", clock) as ph:
            phase_generator(ph)
        with Phase("2 PE", clock) as ph:
            phase_pe(ph, tmp)
        with Phase("3 scan", clock) as ph:
            phase_scan(ph, tmp)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
