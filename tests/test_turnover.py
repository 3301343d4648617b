"""Turnover (fold) handling in the FD kernel: two-branch evaluation.

The reference construction evaluates every monotone branch of f_i(t) with
the uniform Bessel-K(1/3) SPA factor (arXiv:2307.12585; notebook cell 26's
``kv(1/3, arg)`` terms); near a fold (fdot = 0) the two branches' factors
sum to the Airy caustic behavior. `fd_mode_sum(..., turnover_slots=N)`
assigns the decreasing branch of the top-power turnover modes to extra
scan slots (node traversal reversed so f ascends, Bessel factor
conjugated).

The synthetic fold test is the strong one: a manufactured quadratic fold
f(t) = fc - b/2 (t-tc)^2 with A = 1 has a brute-force-integrable spectrum
showing O(1) interference fringes between the branches — the two-branch
kernel must track them, the single-branch kernel cannot.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from emri_frequencydomainwaveforms_tpu.models.amplitude import default_mode_table
from emri_frequencydomainwaveforms_tpu.models.summation_fd import (
    FDKernelInputs,
    fd_mode_sum,
    prepare_fd_inputs,
)
from emri_frequencydomainwaveforms_tpu.models.waveform import (
    _sigma,
    fd_waveform_core,
    waveform_prologue,
)
from emri_frequencydomainwaveforms_tpu.ops.cubic_spline import (
    fit_cubic_spline,
    spline_eval,
)


def _synthetic_fold_inputs(fc=1e-3, b=1e-14, tc=5e5, T=1e6, K=64):
    """FDKernelInputs for one unit-amplitude mode with a quadratic fold."""
    t = np.linspace(0, T, K)
    phi = 2 * np.pi * (fc * t - (b / 6) * (t - tc) ** 3)
    tj = jnp.asarray(t)
    sp = fit_cubic_spline(tj, jnp.asarray(phi), bc="not-a-knot")
    f_k = np.asarray(spline_eval(sp, tj, deriv=1)) / (2 * np.pi)
    inc_hi = int(np.argmax(np.diff(f_k) < 0))
    one = jnp.ones((1,))
    return FDKernelInputs(
        t_knots=tj,
        c_phi_phi=sp.c,
        c_phi_r=jnp.zeros_like(sp.c),
        f_phi_knots=jnp.asarray(f_k),
        f_r_knots=jnp.zeros_like(tj),
        ar_c=jnp.zeros((1, K - 1, 4)).at[:, :, 0].set(1.0),
        ai_c=jnp.zeros((1, K - 1, 4)),
        m_sel=one,
        n_sel=jnp.zeros((1,)),
        w1_re=one,
        w1_im=jnp.zeros((1,)),
        w2_re=one,
        w2_im=jnp.zeros((1,)),
        mode_live=one,
        n_live=jnp.asarray(K, jnp.int32),
        n_eff=jnp.asarray([inc_hi + 1], jnp.int32),
        inc_lo=jnp.asarray([0], jnp.int32),
        inc_hi=jnp.asarray([inc_hi], jnp.int32),
        inc_live=one,
        dec_lo=jnp.asarray([inc_hi], jnp.int32),
        dec_hi=jnp.asarray([K - 1], jnp.int32),
        dec_live=one,
        power=one,
        neg_lo=jnp.asarray([0], jnp.int32),
        neg_hi=jnp.asarray([0], jnp.int32),
        neg_live=jnp.zeros((1,)),
        w1n_re=jnp.zeros((1,)),
        w1n_im=jnp.zeros((1,)),
        w2n_re=jnp.zeros((1,)),
        w2n_im=jnp.zeros((1,)),
    ), (fc, b, tc, T)


class TestSyntheticFold:
    def test_two_branch_matches_brute_force(self):
        inp, (fc, b, tc, T) = _synthetic_fold_inputs()
        # overlap band: both branches contribute, O(1) interference fringes
        fs = np.linspace(0.75e-3, 0.985e-3, 10)
        o1 = fd_mode_sum(inp, jnp.asarray(fs), turnover_slots=1)
        kw = np.asarray(o1[0]) + 1j * np.asarray(o1[1])
        tg = np.linspace(0, T, 2_000_001)
        dt = tg[1] - tg[0]
        phig = 2 * np.pi * (fc * tg - (b / 6) * (tg - tc) ** 3)
        for i, f in enumerate(fs):
            v = np.trapezoid(np.exp(1j * (phig - 2 * np.pi * f * tg)), dx=dt)
            np.testing.assert_allclose(abs(kw[i]) / abs(v), 1.0, atol=0.03)
            assert abs(np.angle(kw[i] / v)) < 0.03

    def test_single_branch_misses_fringes(self):
        # sanity: without turnover slots the fringe pattern CANNOT appear —
        # verifies the previous test is actually exercising the new path
        inp, (fc, b, tc, T) = _synthetic_fold_inputs()
        fs = np.linspace(0.75e-3, 0.985e-3, 10)
        o0 = fd_mode_sum(inp, jnp.asarray(fs), turnover_slots=0)
        o1 = fd_mode_sum(inp, jnp.asarray(fs), turnover_slots=1)
        k0 = np.abs(np.asarray(o0[0]) + 1j * np.asarray(o0[1]))
        k1 = np.abs(np.asarray(o1[0]) + 1j * np.asarray(o1[1]))
        # two-branch spectrum oscillates (fringes); single-branch is smooth
        assert np.std(np.diff(k1)) > 5 * np.std(np.diff(k0))


class TestPlungingSource:
    def test_turnover_adds_finite_inband_content(self):
        # p0 near separatrix: plunges at ~0.03 yr; mode (2,2,4) turns over
        table = default_mode_table(16, l_max=2)
        pro = waveform_prologue(
            1e6, 50.0, 7.6, 0.3, 0.7, 0.5, 1.0, 0.0, 0.0,
            t_years=1.0, table=table, k_max=32, eps=1e-2,
        )
        sig = _sigma(table)
        ypr, ypi = pro.y_plus
        ymr, ymi = pro.y_minus
        inp = prepare_fd_inputs(
            pro.t_knots, pro.n_live, pro.phi_phi, pro.phi_r,
            pro.a_re, pro.a_im, table, pro.sel,
            (sig * ymr, sig * ymi), (ypr, -ypi),
        )
        assert int(np.asarray(inp.dec_live).sum()) >= 1  # a real turnover

        f_grid = jnp.asarray(np.linspace(1e-3, 7e-3, 2048))
        o1 = fd_waveform_core(pro, table, f_grid, channels=False, turnover_slots=4)
        o0 = fd_waveform_core(pro, table, f_grid, channels=False, turnover_slots=0)
        a1 = np.asarray(o1[0]) + 1j * np.asarray(o1[1])
        a0 = np.asarray(o0[0]) + 1j * np.asarray(o0[1])
        assert np.isfinite(a1).all() and np.isfinite(a0).all()
        diff = np.abs(a1 - a0)
        # the decreasing branch contributes at a level comparable to the
        # local single-branch amplitude, confined to its (narrow) band
        assert diff.max() > 0.1 * np.abs(a0).max()
        contributing = diff > 1e-6 * np.abs(a0).max()
        assert 0 < contributing.sum() < len(f_grid) // 4

    def test_jit_vmap_with_turnover(self):
        table = default_mode_table(8, l_max=2)
        f_pos = jnp.linspace(1e-3, 6e-3, 64)

        @jax.jit
        def gen(p0):
            pro = waveform_prologue(
                1e6, 50.0, p0, 0.3, 0.7, 0.5, 1.0, 0.0, 0.0,
                t_years=0.5, table=table, k_max=16, eps=1e-3,
            )
            return fd_waveform_core(pro, table, f_pos, turnover_slots=2)

        out = jax.vmap(gen)(jnp.array([7.6, 8.0, 9.0]))
        for o in out:
            assert np.isfinite(np.asarray(o)).all()


class TestNegativeFrequencyBranch:
    """Negative-frequency (direct-term) radiation in the FD kernel.

    Ranges where f_mn(t) < 0 radiate at +|f| through the DIRECT term
    A Y^+ e^{-i Phi}; under U = -Phi this is the partner-term kernel with
    negated phase coefficients, conj-flipped amplitudes, and the
    conjugated weight pairs. Validated against the golden scipy pipeline
    evaluated on the mirrored phase.
    """

    def test_matches_golden_on_mirrored_phase(self):
        from scipy.interpolate import CubicSpline

        from tests.test_golden_fd import _golden_fd_positive
        from emri_frequencydomainwaveforms_tpu.models.modeselect import (
            table_indices_for,
        )

        table = default_mode_table(12, l_max=2)
        forced = table_indices_for(table, [(2, 2, -8)])  # f = 2 om_phi - 8 om_r < 0
        pro = waveform_prologue(
            1e6, 50.0, 10.0, 0.4, np.pi / 4, np.pi / 3, 1.0, 1.0, 2.0,
            t_years=0.25, table=table, k_max=1, eps=1e-2, forced_idx=forced,
        )
        n = int(pro.n_live)
        t = np.asarray(pro.t_knots)[:n]
        phase = 2 * np.asarray(pro.phi_phi)[:n] - 8 * np.asarray(pro.phi_r)[:n]
        g = -CubicSpline(t, phase).derivative()(t) / (2 * np.pi)
        assert (g > 0).all()  # the mode is negative-frequency throughout
        dg = np.diff(g)
        stop = int(np.argmax(dg <= 0)) if (dg <= 0).any() else n - 1
        assert stop > 20  # a substantial first increasing run of g = -f

        idx = int(forced[0])
        a_re = np.asarray(pro.a_re)[: stop + 1, idx]
        a_im = np.asarray(pro.a_im)[: stop + 1, idx]
        yp = np.asarray(pro.y_plus[0])[idx] + 1j * np.asarray(pro.y_plus[1])[idx]

        nb = 1024
        f_lo, f_hi = g[0], g[stop]
        pad = (f_hi - f_lo) / nb
        f_grid = np.linspace(f_lo + pad, f_hi - pad, nb)
        golden = _golden_fd_positive(
            t[: stop + 1], -phase[: stop + 1], a_re, -a_im, yp, f_grid
        ) * float(pro.dist_factor)

        o1 = fd_waveform_core(
            pro, table, jnp.asarray(f_grid), channels=False, negative_slots=1
        )
        o0 = fd_waveform_core(
            pro, table, jnp.asarray(f_grid), channels=False, negative_slots=0
        )
        ours = np.asarray(o1[0]) + 1j * np.asarray(o1[1])
        base = np.asarray(o0[0]) + 1j * np.asarray(o0[1])
        assert np.abs(base).max() == 0.0  # masked without negative slots
        assert np.isfinite(ours).all()

        h = np.hanning(nb)
        num = np.abs(np.sum(h * np.conj(golden) * ours))
        den = np.sqrt(
            np.sum(h * np.abs(golden) ** 2) * np.sum(h * np.abs(ours) ** 2)
        )
        assert 1.0 - num / den < 1e-4

    def test_channels_mode_finite(self):
        table = default_mode_table(10, l_max=2)
        f_pos = jnp.linspace(5e-4, 6e-3, 128)
        pro = waveform_prologue(
            1e6, 50.0, 9.0, 0.35, 0.7, 0.5, 1.0, 0.0, 0.0,
            t_years=0.25, table=table, k_max=24, eps=1e-3,
        )
        out = fd_waveform_core(
            pro, table, f_pos, channels=True, turnover_slots=2, negative_slots=4
        )
        for o in out:
            assert np.isfinite(np.asarray(o)).all()


@pytest.fixture(scope="module")
def plunging_banded():
    """Shared expensive artifacts for the banded-turnover tests (round-5
    suite ergonomics): ONE plunging prologue, ONE full-slot banded
    evaluation, ONE no-slot banded evaluation, computed once per module
    instead of per test (each fd_mode_sum over 240k bins is ~1 min on the
    1-core CI box)."""
    from emri_frequencydomainwaveforms_tpu.models.summation_fd import (
        fd_mode_sum_uniform,
    )

    table = default_mode_table(16, l_max=2)
    pro = waveform_prologue(
        1e6, 50.0, 7.6, 0.3, 0.7, 0.5, 1.0, 0.0, 0.0,
        t_years=1.0, table=table, k_max=32, eps=1e-2,
    )
    sig = _sigma(table)
    ypr, ypi = pro.y_plus
    ymr, ymi = pro.y_minus
    inp = prepare_fd_inputs(
        pro.t_knots, pro.n_live, pro.phi_phi, pro.phi_r,
        pro.a_re, pro.a_im, table, pro.sel,
        (sig * ymr, sig * ymi), (ypr, -ypi),
        w1n=(ypr, ypi), w2n=(sig * ymr, -sig * ymi),
    )
    f0, df, nf = 1e-3, 2.5e-8, 240000
    banded_full = fd_mode_sum_uniform(
        inp, f0, df, nf, bins_per_run=16, turnover_slots=4,
        negative_slots=4, extra_band_runs=2048,
    )
    b0 = np.asarray(fd_mode_sum_uniform(inp, f0, df, nf, bins_per_run=16)[0])
    return inp, (f0, df, nf), banded_full, b0


class TestBandedTurnover:
    """Round 3: the banded uniform production kernel carries the same
    turnover/negative content as the general kernel (second scan with its
    own window budget)."""

    def test_banded_matches_general_with_slots(self, plunging_banded):
        inp, (f0, df, nf), banded, _b0 = plunging_banded
        assert int(np.asarray(inp.dec_live).sum()) >= 1
        f = f0 + df * np.arange(nf)
        general = fd_mode_sum(
            inp, jnp.asarray(f), turnover_slots=4, negative_slots=4
        )
        for b, g in zip(banded, general):
            b, g = np.asarray(b), np.asarray(g)
            scale = np.sqrt(np.mean(b**2)) + 1e-300
            rel = np.sqrt(np.mean((b - g) ** 2)) / scale
            # fold-resolution limit of the uniform-in-f node grid (module
            # docstring): percent-level at the fold bins, ~2e-7 elsewhere
            assert rel < 2e-2

    def test_banded_turnover_adds_content(self, plunging_banded):
        _inp, _grid, banded, b0 = plunging_banded
        b4 = np.asarray(banded[0])
        rel = np.sqrt(np.mean((b4 - b0) ** 2)) / np.sqrt(np.mean(b0**2))
        assert 1e-4 < rel < 0.5  # real, bounded decreasing/negative content
        assert np.isfinite(b4).all()

    def test_chirp_regime_agreement_tight(self):
        # non-plunging source: banded (incl. dead extra slots) vs general
        # at the interpolation-error level over the whole band, edges
        # included (the round-2 exclusion zone is gone)
        from emri_frequencydomainwaveforms_tpu.models.summation_fd import (
            fd_mode_sum_uniform,
        )

        table = default_mode_table(30)
        pro = waveform_prologue(
            1e6, 50.0, 10.0, 0.4, 0.7, 0.5, 1.0, 1.0, 2.0,
            t_years=0.05, table=table, k_max=16, eps=1e-2,
        )
        sig = _sigma(table)
        ypr, ypi = pro.y_plus
        ymr, ymi = pro.y_minus
        inp = prepare_fd_inputs(
            pro.t_knots, pro.n_live, pro.phi_phi, pro.phi_r,
            pro.a_re, pro.a_im, table, pro.sel,
            (sig * ymr, sig * ymi), (ypr, -ypi),
        )
        f0, df, nf = 1.7e-3, 2e-8, 60000
        f = f0 + df * np.arange(nf)
        banded = fd_mode_sum_uniform(
            inp, f0, df, nf, bins_per_run=8, band_runs=4096, turnover_slots=2
        )
        general = fd_mode_sum(inp, jnp.asarray(f), turnover_slots=2)
        for b, g in zip(banded, general):
            b, g = np.asarray(b), np.asarray(g)
            scale = np.sqrt(np.mean(b**2)) + 1e-300
            assert np.sqrt(np.mean((b - g) ** 2)) / scale < 1e-5

    def test_chirp_agreement_rwz_physics(self):
        # round 4: the same banded/general equivalence with the FULL
        # calibrated amplitude stack (tail + factorized + rwz), whose
        # per-mode omega-dependent complex rotations exercise the kernels'
        # envelope-phase paths. On CPU (exact f64 arithmetic) the kernels
        # are algorithmically equivalent at the interpolation-error level;
        # the bench gate uses a looser 1e-3 threshold, set when the two
        # kernels' INDEPENDENT f32 phase-pipeline rounding decorrelated
        # under these per-mode rotations on the first target device.
        from emri_frequencydomainwaveforms_tpu.models.summation_fd import (
            fd_mode_sum_uniform,
        )

        table = default_mode_table(30)
        pro = waveform_prologue(
            1e6, 50.0, 10.0, 0.4, 0.7, 0.5, 1.0, 1.0, 2.0,
            t_years=0.05, table=table, k_max=16, eps=1e-2,
            flux="multipole_rwz", tail=True, factorized=True, rwz=True,
        )
        sig = _sigma(table)
        ypr, ypi = pro.y_plus
        ymr, ymi = pro.y_minus
        inp = prepare_fd_inputs(
            pro.t_knots, pro.n_live, pro.phi_phi, pro.phi_r,
            pro.a_re, pro.a_im, table, pro.sel,
            (sig * ymr, sig * ymi), (ypr, -ypi),
        )
        f0, df, nf = 1.7e-3, 2e-8, 60000
        f = f0 + df * np.arange(nf)
        banded = fd_mode_sum_uniform(
            inp, f0, df, nf, bins_per_run=8, band_runs=4096, turnover_slots=2
        )
        general = fd_mode_sum(inp, jnp.asarray(f), turnover_slots=2)
        for b, g in zip(banded, general):
            b, g = np.asarray(b), np.asarray(g)
            scale = np.sqrt(np.mean(b**2)) + 1e-300
            assert np.sqrt(np.mean((b - g) ** 2)) / scale < 1e-4
