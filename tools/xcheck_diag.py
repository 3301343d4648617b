"""Decompose the banded-vs-general kernel cross-check residual (gate 1).

Reproduces bench.py gate 1's exact configuration (1-yr grid, rwz physics,
64-bin runs, turnover_slots=2) on the CPU backend, where both kernels run
the same mixed-precision arithmetic under exact IEEE rounding — any
residual is DETERMINISTIC interpolation/algorithm difference, not device
noise. Then ablates:

  * banded node resolution: bins_per_run 64 / 32 / 16 — if the residual
    falls with the banded node spacing, the banded kernel's uniform-in-f
    node grid is the under-resolved side;
  * general node resolution: nodes_per_segment 32 / 64 — ditto for the
    general kernel's uniform-in-t nodes;
  * per-output worst bins — where in the band the disagreement lives.

Run: PYTHONPATH=. JAX_PLATFORMS='' python tools/xcheck_diag.py [--nf N]
"""

import argparse
import os
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nf", type=int, default=0, help="0 = full 1-yr grid")
    ap.add_argument("--stride", type=int, default=617)
    ap.add_argument("--quick", action="store_true",
                    help="skip the ablation sweep, print the baseline only")
    ap.add_argument("--device", action="store_true",
                    help="run on JAX's default device (the GPU) instead of the CPU")
    ap.add_argument("--save", type=str, default=None,
                    help="npz path: dump the baseline b64/g32 arrays")
    ap.add_argument("--compare", type=str, default=None,
                    help="npz from --save on the other backend: report "
                         "per-kernel cross-device agreement")
    args = ap.parse_args()

    import jax

    if not args.device:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    import emri_frequencydomainwaveforms_tpu  # noqa: F401  (x64 config)
    from emri_frequencydomainwaveforms_tpu.models.amplitude import (
        default_mode_table,
    )
    from emri_frequencydomainwaveforms_tpu.models.waveform import (
        default_frequencies,
        fd_waveform_core,
        waveform_prologue,
    )

    T_YEARS, DT, EPS, K_MAX, MAX_STEPS = 1.0, 10.0, 1e-2, 16, 192
    PHYS_KW = dict(flux="multipole_rwz", tail=True, factorized=True, rwz=True)

    table = default_mode_table(30)
    freq = default_frequencies(T_YEARS, DT)
    f_np = freq[freq > 0]
    if args.nf:
        f_np = f_np[: args.nf]
    nf = len(f_np)
    f0u, dfu = float(f_np[0]), float(f_np[1] - f_np[0])
    uniform = (f0u, dfu)

    pro_sel = jax.jit(
        lambda: waveform_prologue(
            1e6, 10.0, 12.0, 0.35, 0.7, 0.5, 1.0, 0.0, 0.0,
            t_years=T_YEARS, table=table, k_max=K_MAX, eps=EPS,
            max_steps=MAX_STEPS, **PHYS_KW,
        )
    )()
    table_k = table.take(np.asarray(pro_sel.sel.idx))
    idx_k = np.arange(len(np.asarray(pro_sel.sel.idx)))

    pro = jax.jit(
        lambda: waveform_prologue(
            1e6, 10.0, 12.0, 0.35, 0.7, 0.5, 1.0, 0.0, 0.0,
            t_years=T_YEARS, table=table_k, k_max=K_MAX, eps=EPS,
            max_steps=MAX_STEPS, forced_idx=idx_k, **PHYS_KW,
        )
    )()

    sub = np.arange(0, nf, args.stride)
    f_sub = jnp.asarray(f_np[sub])

    def banded(bins_per_run):
        out = jax.jit(
            lambda p: fd_waveform_core(
                p, table_k, jnp.asarray(f_np), channels=True, uniform=uniform,
                bins_per_run=bins_per_run, turnover_slots=2,
            )
        )(pro)
        return [np.asarray(o)[sub] for o in out]

    def general(nodes_per_segment):
        out = jax.jit(
            lambda p: fd_waveform_core(
                p, table_k, f_sub, channels=True, turnover_slots=2,
                nodes_per_segment=nodes_per_segment,
            )
        )(pro)
        return [np.asarray(o) for o in out]

    def rel(a4, b4):
        worst = 0.0
        for x, y in zip(a4, b4):
            scale = np.sqrt(np.mean(x**2)) + 1e-300
            worst = max(worst, float(np.sqrt(np.mean((x - y) ** 2)) / scale))
        return worst

    g32 = general(32)
    b64 = banded(64)
    base = rel(b64, g32)
    print(f"baseline  banded(r=64) vs general(s=32): {base:.3e}", flush=True)

    if args.save:
        np.savez(args.save, b64=np.stack(b64), g32=np.stack(g32))
        print(f"saved baseline arrays to {args.save}", flush=True)
    if args.compare:
        other = np.load(args.compare)
        print(
            f"banded THIS-dev vs OTHER-dev:  {rel(b64, list(other['b64'])):.3e}",
            flush=True,
        )
        print(
            f"general THIS-dev vs OTHER-dev: {rel(g32, list(other['g32'])):.3e}",
            flush=True,
        )

    if args.quick:
        return

    b32 = banded(32)
    b16 = banded(16)
    print(f"banded(r=32) vs general(s=32): {rel(b32, g32):.3e}", flush=True)
    print(f"banded(r=16) vs general(s=32): {rel(b16, g32):.3e}", flush=True)
    g64 = general(64)
    print(f"banded(r=64) vs general(s=64): {rel(b64, g64):.3e}", flush=True)
    print(f"banded(r=16) vs general(s=64): {rel(b16, g64):.3e}", flush=True)
    print(f"general(s=32) vs general(s=64): {rel(g32, g64):.3e}", flush=True)
    print(f"banded(r=64) vs banded(r=16): {rel(b64, b16):.3e}", flush=True)

    # локate the worst bins of the baseline comparison
    x, y = b64[0], g32[0]
    scale = np.sqrt(np.mean(x**2))
    err = np.abs(x - y) / scale
    order = np.argsort(err)[::-1][:12]
    print("worst bins (idx in sub, f[Hz], rel err):")
    for i in order:
        print(f"  {i:6d}  f={f_np[sub[i]]:.6e}  {err[i]:.3e}")


if __name__ == "__main__":
    sys.exit(main())
