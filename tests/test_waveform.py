"""End-to-end waveform tests: FD vs TD consistency (the paper's core claim).

Mirrors the reference's validation strategy (``check_mode_by_mode.py``
windowed mismatches; ``Tutorial_FD_construction_single_mode.ipynb`` cells
26-32 FD-vs-FFT comparison) using this framework's own TD path as truth.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.models.waveform import (
    FastSchwarzschildEccentricFlux,
    GenerateEMRIWaveform,
    fd_waveform_core,
    waveform_prologue,
)
from emri_frequencydomainwaveforms_tpu.models.amplitude import default_mode_table
from emri_frequencydomainwaveforms_tpu.utils.fdutils import (
    get_fd_windowed,
    get_fft_td_windowed,
)

PARS = [1e6, 50.0, 0.0, 10.0, 0.4, 1.0, 1.0, np.pi / 4, np.pi / 3, np.pi / 5, np.pi / 6, 1.0, 0.0, 2.0]
T, DT = 0.1, 10.0


def _mismatch(a, b):
    num = np.abs(np.vdot(a, b))
    den = np.sqrt(np.vdot(a, a).real * np.vdot(b, b).real)
    return 1.0 - num / den


@pytest.fixture(scope="module")
def generators():
    # CI-size inventory (n_max=16, l<=3): the full-table FD/TD gate runs on
    # the GPU inside bench.py
    kw = dict(return_list=True, n_max=16, l_max=3)
    td = GenerateEMRIWaveform(sum_kwargs=dict(odd_len=True), **kw)
    fd = GenerateEMRIWaveform(sum_kwargs=dict(output_type="fd", odd_len=True), **kw)
    return td, fd


class TestFDvsTD:
    @pytest.mark.parametrize("case", ["single", "allmode"])
    def test_windowed_mismatch_under_gate(self, generators, case):
        td_gen, fd_gen = generators
        kw = dict(T=T, dt=DT)
        if case == "single":
            kw["mode_selection"] = [(2, 2, 0)]
        else:
            kw["eps"] = 1e-2
        htd = td_gen(*PARS, **kw)
        hfd = fd_gen(*PARS, **kw)
        n = len(htd[0])
        w = np.hanning(n)
        fd_w = get_fd_windowed(hfd, w)
        td_w = get_fft_td_windowed(htd, w, DT)
        pos = fd_gen.frequency >= 0
        for a, b in zip(fd_w, td_w):
            # band-edge effects scale ~1/T; at T=0.1 yr the floor is ~3e-4
            # (T=0.2 -> 8.7e-5, under the 1e-4 gate quoted for 1-yr signals;
            # the full-length gate runs on the GPU in bench.py)
            assert _mismatch(a[pos], b[pos]) < 5e-4

    def test_scalar_vs_list_consistency(self, generators):
        td_gen, _ = generators
        scalar_gen = GenerateEMRIWaveform(sum_kwargs=dict(odd_len=True), return_list=False)
        kw = dict(T=0.02, dt=DT, mode_selection=[(2, 2, 0)])
        hp, hc = td_gen(*PARS, **kw)
        h = scalar_gen(*PARS, **kw)
        np.testing.assert_allclose(np.asarray(h), np.asarray(hp) - 1j * np.asarray(hc), rtol=1e-12)

    def test_fd_downsampling_consistency(self):
        # FD model on a sparse f_arr == same bins of the full grid (the
        # property that enables downsampled likelihoods, emri_pe.py:322-391)
        fd_gen = GenerateEMRIWaveform(
            sum_kwargs=dict(output_type="fd", odd_len=True), return_list=True,
            n_max=10, l_max=2,
        )
        kw = dict(T=0.02, dt=DT, eps=1e-2)
        full = fd_gen(*PARS, **kw)
        freq = fd_gen.frequency
        sub = slice(None, None, 100)
        f_sub = freq[sub]
        down = fd_gen(*PARS, f_arr=f_sub, **kw)
        for ch_full, ch_down in zip(full, down):
            a, b = ch_full[sub], ch_down
            # full grid runs the banded uniform kernel, the (asymmetric)
            # subset grid runs the general kernel — agreement is at the
            # interpolation-error level, not bit-exact
            peak = np.abs(a).max()
            good = np.abs(a) > 1e-3 * peak
            rel = np.abs(a[good] - b[good]) / np.abs(a[good])
            assert np.median(rel) < 1e-3
            num = np.abs(np.vdot(a, b))
            den = np.sqrt(np.vdot(a, a).real * np.vdot(b, b).real)
            assert 1.0 - num / den < 1e-5

    def test_mask_positive(self):
        fd = FastSchwarzschildEccentricFlux(sum_kwargs=dict(output_type="fd", odd_len=True))
        h = fd(1e6, 50.0, 10.0, 0.4, np.pi / 4, np.pi / 3, T=0.02, dt=DT,
               mode_selection=[(2, 2, 0)], mask_positive=True)
        assert (fd.frequency >= 0).sum() == len(h)

    def test_functional_core_jit_vmap(self):
        table = default_mode_table(8)
        f_pos = jnp.linspace(1e-3, 3e-3, 64)

        @jax.jit
        def gen(p0):
            pro = waveform_prologue(
                1e6, 50.0, p0, 0.3, 0.7, 0.5, 1.0, 0.0, 0.0,
                t_years=0.02, table=table, k_max=16, eps=1e-3,
            )
            return fd_waveform_core(pro, table, f_pos)

        out = jax.vmap(gen)(jnp.array([9.5, 10.0, 10.5, 11.0]))
        assert out[0].shape == (4, 64)
        for o in out:
            assert np.isfinite(np.asarray(o)).all()

    def test_amplitude_scale(self, generators):
        # mu=50 at 1 Gpc: strain ~ 1e-22..1e-21 in TD
        td_gen, _ = generators
        hp, _ = td_gen(*PARS, T=0.02, dt=DT, eps=1e-2)
        peak = np.abs(np.asarray(hp)).max()
        assert 1e-23 < peak < 1e-19


class TestFrozenSelection:
    """Batch-shared slot layout helper (the production banded fast path)."""

    def test_freeze_and_coverage(self):
        from emri_frequencydomainwaveforms_tpu.models.modeselect import mode_power
        from emri_frequencydomainwaveforms_tpu.models.waveform import (
            coverage_of,
            freeze_mode_selection,
        )
        from emri_frequencydomainwaveforms_tpu.utils.ylm import spin_weighted_ylm
        from emri_frequencydomainwaveforms_tpu.models.waveform import (
            default_frequencies,
        )

        table = default_mode_table(16, l_max=2)
        freq = default_frequencies(0.1, 10.0)
        f_np = freq[freq > 0]
        f0u, dfu = float(f_np[0]), float(f_np[1] - f_np[0])
        pro = waveform_prologue(
            1e6, 10.0, 12.0, 0.35, 0.7, 0.5, 1.0, 0.0, 0.0,
            t_years=0.1, table=table, k_max=16, eps=1e-2, max_steps=128,
        )
        fz = freeze_mode_selection(pro, table, f0u, dfu)
        assert 0 < len(fz.forced_idx) <= 16
        assert fz.band_runs % 64 == 0

        # a drifted lane: frozen waveform finite, coverage above the gate
        pro_l = waveform_prologue(
            1e6, 10.0, 12.03, 0.352, 0.72, 0.52, 1.0, 0.0, 0.0,
            t_years=0.1, table=table, k_max=len(fz.forced_idx), eps=1e-2,
            max_steps=128, forced_idx=fz.forced_idx,
        )
        out = fd_waveform_core(
            pro_l, table, jnp.asarray(f_np), channels=True,
            uniform=(f0u, dfu), band_runs=fz.band_runs,
            band_offsets=jnp.asarray(fz.band_offsets),
            bins_per_run=fz.bins_per_run,
        )
        assert all(np.isfinite(np.asarray(o)).all() for o in out)

        # out_f32 fast path: f32 view of the same spectra (dtype only), and
        # the sliced-table prologue (ModeTable.take + arange forced_idx)
        # reproduces the full-table frozen waveform to f32 reassociation
        # (the amplitude projection matmul tiles differently at 16 vs 519
        # columns, so accumulation order shifts at the ~1e-7 f32 level)
        out32 = fd_waveform_core(
            pro_l, table, jnp.asarray(f_np), channels=True,
            uniform=(f0u, dfu), band_runs=fz.band_runs,
            band_offsets=jnp.asarray(fz.band_offsets),
            bins_per_run=fz.bins_per_run, out_f32=True,
        )
        assert all(o.dtype == jnp.float32 for o in out32)
        for a, b in zip(out, out32):
            np.testing.assert_allclose(
                np.asarray(a, np.float32), np.asarray(b), rtol=0, atol=0
            )
        table_k = table.take(fz.forced_idx)
        pro_k = waveform_prologue(
            1e6, 10.0, 12.03, 0.352, 0.72, 0.52, 1.0, 0.0, 0.0,
            t_years=0.1, table=table_k, k_max=len(fz.forced_idx), eps=1e-2,
            max_steps=128, forced_idx=np.arange(len(fz.forced_idx)),
        )
        out_k = fd_waveform_core(
            pro_k, table_k, jnp.asarray(f_np), channels=True,
            uniform=(f0u, dfu), band_runs=fz.band_runs,
            band_offsets=jnp.asarray(fz.band_offsets),
            bins_per_run=fz.bins_per_run,
        )
        for a, b in zip(out, out_k):
            a = np.asarray(a)
            b = np.asarray(b)
            scale = np.sqrt(np.mean(a**2)) + 1e-300
            assert np.sqrt(np.mean((a - b) ** 2)) / scale < 1e-6

        live = (jnp.arange(pro_l.t_knots.shape[0]) < pro_l.n_live).astype(
            jnp.float64
        )
        yp = spin_weighted_ylm(table.ls, table.ms, 0.72, 0.52)
        ym = spin_weighted_ylm(table.ls, -table.ms, 0.72, 0.52)
        power = mode_power(
            pro_l.a_re, pro_l.a_im, yp[0], yp[1], ym[0], ym[1], dt_weights=live
        )
        assert float(coverage_of(fz, power)) > 1.0 - 1.25e-2

        # frozen banded output matches the general kernel away from edges;
        # sample inside the occupied band (short signals put all content in
        # a thin slice of the grid)
        occupied = np.nonzero(np.abs(np.asarray(out[0])) > 0)[0]
        sub = np.arange(occupied[0], occupied[-1], 7)
        gen = fd_waveform_core(pro_l, table, jnp.asarray(f_np[sub]), channels=True)
        b = np.asarray(out[0])[sub]
        g = np.asarray(gen[0])
        scale = np.sqrt(np.mean(b**2)) + 1e-300
        # percent-level: the subset includes band-edge bins (documented
        # O(run_df) envelope offsets); interior bins agree to ~1e-5
        assert np.sqrt(np.mean((b - g) ** 2)) / scale < 3e-2
