"""Reversible-jump / multiple-try / group-move sampler tests.

Ports the reference's trans-dimensional sampler suite
(``Eryn/eryn/tests/test_eryn.py``: ``test_rj``:192,
``test_rj_multiple_branches``:304, ``test_gibbs_sampling``:455,
``test_mt``:906) to the jittable likelihood contract: toy models are
written in jnp over full ``(ntemps, nwalkers, nleaves_max, ndim)`` leaf
arrays with boolean masks (one batched XLA call replaces the reference's
per-leaf host loops).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from emri_frequencydomainwaveforms_tpu.inference import (
    DelayedRejectionRJ,
    DistributionGenerate,
    DistributionGenerateRJ,
    EnsembleSampler,
    GaussianMove,
    MTDistGenMove,
    MTDistGenMoveRJ,
    ProbDistContainer,
    TempHDFBackend,
    make_state,
    uniform_dist,
)
from emri_frequencydomainwaveforms_tpu.inference.moves.group import (
    CombineMove,
    DelayedRejectionMove,
    GroupStretchMove,
)

T_GRID = jnp.asarray(np.linspace(-1, 1, 256))

GAUSS_INJ = np.array(
    [[3.3, -0.2, 0.1], [2.6, -0.1, 0.1], [3.4, 0.0, 0.1], [2.9, 0.3, 0.1]]
)
SINE_INJ = np.array([[1.3, 10.1, 1.0], [0.8, 4.6, 1.2]])
SIGMA = 2.0


def _gauss_sum(coords, inds):
    """Masked gaussian-pulse template over (T, W, L, 3) leaves."""
    a = coords[..., 0]
    b = coords[..., 1]
    c = jnp.where(inds, jnp.abs(coords[..., 2]) + 1e-12, 1.0)
    f = a[..., None] * jnp.exp(
        -((T_GRID - b[..., None]) ** 2) / (2.0 * c[..., None] ** 2)
    )
    return jnp.sum(jnp.where(inds[..., None], f, 0.0), axis=-2)


def _sine_sum(coords, inds):
    a = coords[..., 0]
    b = coords[..., 1]
    c = coords[..., 2]
    f = a[..., None] * jnp.sin(2.0 * jnp.pi * b[..., None] * T_GRID + c[..., None])
    return jnp.sum(jnp.where(inds[..., None], f, 0.0), axis=-2)


def _inject(include_sine=False, seed=42):
    rng = np.random.default_rng(seed)
    tg = np.asarray(T_GRID)
    y = np.zeros_like(tg)
    for a, b, c in GAUSS_INJ:
        y += a * np.exp(-((tg - b) ** 2) / (2 * c**2))
    if include_sine:
        for a, b, c in SINE_INJ:
            y += a * np.sin(2 * np.pi * b * tg + c)
    return y + SIGMA * rng.standard_normal(len(tg))


GAUSS_PRIOR = {
    0: uniform_dist(2.5, 3.5),
    1: uniform_dist(-1.0, 1.0),
    2: uniform_dist(0.01, 0.21),
}
SINE_PRIOR = {
    0: uniform_dist(0.5, 1.5),
    1: uniform_dist(1.0, 20.0),
    2: uniform_dist(0.0, 2 * np.pi),
}


def _init_leaves(inj, nleaves_max, ntemps, nwalkers, rng):
    ndim = inj.shape[1]
    coords = np.zeros((ntemps, nwalkers, nleaves_max, ndim))
    inds = np.zeros((ntemps, nwalkers, nleaves_max), dtype=bool)
    for nn in range(min(len(inj), nleaves_max)):
        coords[:, :, nn] = inj[nn] + 1e-4 * rng.standard_normal(
            (ntemps, nwalkers, ndim)
        )
        inds[:, :, nn] = True
    # dead slots hold in-prior placeholders (they are masked anyway)
    coords[..., ~inds[0, 0], :] = inj[0]
    return coords, inds


class TestRJ:
    """Reference ``test_rj`` equivalent: single-branch birth/death."""

    def test_rj_single_branch(self):
        ntemps, nwalkers, ndim = 2, 16, 3
        nleaves_max = {"gauss": 8}
        nleaves_min = {"gauss": 0}
        rng = np.random.default_rng(0)
        y = jnp.asarray(_inject())

        def log_like(coords, inds, data, sigma):
            tmpl = _gauss_sum(coords, inds)
            return -0.5 * jnp.sum(((tmpl - data) / sigma) ** 2, axis=-1)

        priors = {"gauss": GAUSS_PRIOR}
        priors_gen = {"gauss": ProbDistContainer(GAUSS_PRIOR)}
        moves = GaussianMove({"gauss": np.ones(ndim) * 1e-5})
        rj_moves = [
            DistributionGenerateRJ(
                priors_gen, nleaves_min=nleaves_min, nleaves_max=nleaves_max
            )
        ]

        ens = EnsembleSampler(
            nwalkers,
            {"gauss": ndim},
            log_like,
            priors,
            args=[y, SIGMA],
            tempering_kwargs=dict(ntemps=ntemps),
            branch_names=["gauss"],
            nleaves_max=nleaves_max,
            nleaves_min=nleaves_min,
            moves=moves,
            rj_moves=rj_moves,
        )
        assert ens.multibranch

        coords, inds = _init_leaves(GAUSS_INJ, 8, ntemps, nwalkers, rng)
        state = make_state({"gauss": coords}, inds={"gauss": inds})

        lp = ens.compute_log_prior({"gauss": coords}, inds={"gauss": inds})
        ll, _ = ens.compute_log_like(
            {"gauss": coords}, inds={"gauss": inds}, logp=lp
        )
        assert np.isfinite(np.asarray(lp)).all()
        assert np.isfinite(np.asarray(ll)).all()

        last = ens.run_mcmc(state, 15, burn=5, thin_by=1)

        nleaves = ens.get_nleaves()["gauss"]  # (nsteps, T, W)
        assert nleaves.shape == (15, ntemps, nwalkers)
        assert nleaves.min() >= 0 and nleaves.max() <= 8
        # hot chains explore the leaf count; structure must stay legal
        last_nl = np.asarray(last.branches["gauss"].nleaves)
        assert last_nl.min() >= 0 and last_nl.max() <= 8

        # NaN-filled chain filtering (reference pattern)
        samples = ens.get_chain()["gauss"][:, 0].reshape(-1, ndim)
        live = samples[~np.isnan(samples[:, 0])]
        assert len(live) > 0
        # cold chain should still favor ~4 sources after this short run
        assert 2.0 < nleaves[:, 0].mean() <= 8.0

    def test_rj_multiple_branches_hdf(self):
        ntemps, nwalkers = 2, 12
        ndims = {"gauss": 3, "sine": 3}
        nleaves_max = {"gauss": 8, "sine": 4}
        nleaves_min = {"gauss": 0, "sine": 0}
        rng = np.random.default_rng(1)
        y = jnp.asarray(_inject(include_sine=True))

        def log_like(coords, inds, data, sigma):
            tmpl = _gauss_sum(coords["gauss"], inds["gauss"])
            tmpl = tmpl + _sine_sum(coords["sine"], inds["sine"])
            return -0.5 * jnp.sum(((tmpl - data) / sigma) ** 2, axis=-1)

        priors = {"gauss": GAUSS_PRIOR, "sine": SINE_PRIOR}
        moves = GaussianMove(
            {"gauss": np.ones(3) * 1e-5, "sine": np.ones(3) * 1e-5}
        )

        with TempHDFBackend() as backend:
            ens = EnsembleSampler(
                nwalkers,
                ndims,
                log_like,
                priors,
                args=[y, SIGMA],
                tempering_kwargs=dict(ntemps=ntemps),
                branch_names=["gauss", "sine"],
                nleaves_max=nleaves_max,
                nleaves_min=nleaves_min,
                moves=moves,
                rj_moves=True,
                backend=backend,
            )
            cg, ig = _init_leaves(GAUSS_INJ, 8, ntemps, nwalkers, rng)
            cs, is_ = _init_leaves(SINE_INJ, 4, ntemps, nwalkers, rng)
            state = make_state(
                {"gauss": cg, "sine": cs}, inds={"gauss": ig, "sine": is_}
            )
            last = ens.run_mcmc(state, 10, burn=3, thin_by=1)

            nl_g = ens.get_nleaves()["gauss"]
            nl_s = ens.get_nleaves()["sine"]
            assert nl_g.shape == (10, ntemps, nwalkers)
            assert nl_s.max() <= 4
            chains = ens.get_chain()
            assert chains["gauss"].shape == (10, ntemps, nwalkers, 8, 3)
            assert chains["sine"].shape == (10, ntemps, nwalkers, 4, 3)

            # HDF resume surface: last sample round-trips with inds
            resumed = backend.get_last_sample()
            for name in ("gauss", "sine"):
                np.testing.assert_array_equal(
                    np.asarray(resumed.branches[name].inds),
                    np.asarray(last.branches[name].inds),
                )

    def test_gibbs_branch_setup(self):
        # random-scan Gibbs over branches: sine branch pinned
        # (nleaves_min == nleaves_max), only gauss counts change
        ntemps, nwalkers = 2, 12
        ndims = {"gauss": 3, "sine": 3}
        nleaves_max = {"gauss": 8, "sine": 2}
        nleaves_min = {"gauss": 0, "sine": 2}
        rng = np.random.default_rng(3)
        y = jnp.asarray(_inject(include_sine=True))

        def log_like(coords, inds, data, sigma):
            tmpl = _gauss_sum(coords["gauss"], inds["gauss"])
            tmpl = tmpl + _sine_sum(coords["sine"], inds["sine"])
            return -0.5 * jnp.sum(((tmpl - data) / sigma) ** 2, axis=-1)

        from emri_frequencydomainwaveforms_tpu.inference.moves.tree import (
            TreeGaussianMove,
        )

        moves = TreeGaussianMove(
            {"gauss": np.ones(3) * 1e-5, "sine": np.ones(3) * 1e-5},
            gibbs_branches=[("gauss",), ("sine",)],
        )
        ens = EnsembleSampler(
            nwalkers,
            ndims,
            log_like,
            {"gauss": GAUSS_PRIOR, "sine": SINE_PRIOR},
            args=[y, SIGMA],
            tempering_kwargs=dict(ntemps=ntemps),
            branch_names=["gauss", "sine"],
            nleaves_max=nleaves_max,
            nleaves_min=nleaves_min,
            moves=moves,
            rj_moves=True,
        )
        cg, ig = _init_leaves(GAUSS_INJ, 8, ntemps, nwalkers, rng)
        cs, is_ = _init_leaves(SINE_INJ, 2, ntemps, nwalkers, rng)
        state = make_state(
            {"gauss": cg, "sine": cs}, inds={"gauss": ig, "sine": is_}
        )
        ens.run_mcmc(state, 8, burn=2)
        # pinned branch never changes leaf count
        nl_s = ens.get_nleaves()["sine"]
        assert (nl_s == 2).all()


class TestMT:
    """Reference ``test_mt`` equivalent: independent multiple-try."""

    def test_mt_gaussian_posterior(self):
        ndim, nwalkers, ntemps = 3, 20, 4
        means = np.zeros(ndim)
        invcov = np.eye(ndim)

        def log_like(x, mu, ic):
            d = x - mu
            return -0.5 * jnp.einsum("ni,ij,nj->n", d, jnp.asarray(ic), d)

        priors_in = {i: uniform_dist(-5.0, 5.0) for i in range(ndim)}
        priors = ProbDistContainer(priors_in)
        mt = MTDistGenMove(priors, num_try=10, independent=True)

        ens = EnsembleSampler(
            nwalkers,
            ndim,
            log_like,
            priors,
            args=[means, invcov],
            moves=mt,
            tempering_kwargs={"ntemps": ntemps},
        )
        coords = priors.rvs(size=(ntemps, nwalkers))
        ens.run_mcmc(coords[:, :, None, :], 50, burn=15)

        samples = ens.get_chain()["model_0"][:, 0].reshape(-1, ndim)
        # an independence sampler from the prior mixes fast: the N(0,1)
        # posterior moments must come out right
        assert abs(samples.mean()) < 0.25
        assert abs(samples.std() - 1.0) < 0.2
        assert ens.acceptance_fraction.mean() > 0.01


class TestDistGen:
    """Reference ``distgen.py:10`` equivalent: prior-draw independence MH."""

    def test_flat_gaussian_posterior(self):
        ndim, nwalkers, ntemps = 2, 24, 2

        def log_like(x):
            return -0.5 * jnp.sum(x**2, axis=-1)

        priors = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(ndim)})
        move = DistributionGenerate(priors)
        ens = EnsembleSampler(
            nwalkers, ndim, log_like, priors, moves=move,
            tempering_kwargs={"ntemps": ntemps},
        )
        coords = priors.rvs(size=(ntemps, nwalkers))
        ens.run_mcmc(coords[:, :, None, :], 120, burn=20)
        samples = ens.get_chain()["model_0"][:, 0].reshape(-1, ndim)
        assert abs(samples.mean()) < 0.2
        assert abs(samples.std() - 1.0) < 0.2
        assert ens.acceptance_fraction.mean() > 0.01

    def test_tree_contract_runs(self):
        # multi-leaf branch: active leaves redrawn, masked slots untouched
        ntemps, nwalkers, ndim = 1, 12, 3
        rng = np.random.default_rng(3)
        y = jnp.asarray(_inject())

        def log_like(coords, inds, data, sigma):
            tmpl = _gauss_sum(coords, inds)
            return -0.5 * jnp.sum(((tmpl - data) / sigma) ** 2, axis=-1)

        priors = {"gauss": GAUSS_PRIOR}
        gen = {"gauss": ProbDistContainer(GAUSS_PRIOR)}
        move = DistributionGenerate(gen)
        ens = EnsembleSampler(
            nwalkers, {"gauss": ndim}, log_like, priors, args=[y, SIGMA],
            branch_names=["gauss"], nleaves_max={"gauss": 6},
            nleaves_min={"gauss": 0}, moves=move,
            rj_moves=[DistributionGenerateRJ(
                {"gauss": ProbDistContainer(GAUSS_PRIOR)},
                nleaves_min={"gauss": 0}, nleaves_max={"gauss": 6},
            )],
        )
        coords, inds = _init_leaves(GAUSS_INJ, 6, ntemps, nwalkers, rng)
        state = make_state({"gauss": coords}, inds={"gauss": inds})
        last = ens.run_mcmc(state, 10, burn=2)
        assert np.isfinite(np.asarray(last.log_like)).all()
        nl = np.asarray(last.branches["gauss"].nleaves)
        assert nl.min() >= 0 and nl.max() <= 6


class TestMTRJ:
    """Reference ``test_mt_rj`` equivalent (``mtdistgenrj.py:7``)."""

    def test_mt_rj_leaf_count_recovery(self):
        ntemps, nwalkers, ndim = 2, 16, 3
        nleaves_max = {"gauss": 8}
        nleaves_min = {"gauss": 0}
        rng = np.random.default_rng(7)
        y = jnp.asarray(_inject())

        def log_like(coords, inds, data, sigma):
            tmpl = _gauss_sum(coords, inds)
            return -0.5 * jnp.sum(((tmpl - data) / sigma) ** 2, axis=-1)

        priors = {"gauss": GAUSS_PRIOR}
        gen = {"gauss": ProbDistContainer(GAUSS_PRIOR)}
        moves = GaussianMove({"gauss": np.ones(ndim) * 1e-5})
        rj_moves = [MTDistGenMoveRJ(
            gen, num_try=8, nleaves_min=nleaves_min, nleaves_max=nleaves_max
        )]
        ens = EnsembleSampler(
            nwalkers, {"gauss": ndim}, log_like, priors, args=[y, SIGMA],
            tempering_kwargs=dict(ntemps=ntemps), branch_names=["gauss"],
            nleaves_max=nleaves_max, nleaves_min=nleaves_min,
            moves=moves, rj_moves=rj_moves,
        )
        coords, inds = _init_leaves(GAUSS_INJ, 8, ntemps, nwalkers, rng)
        state = make_state({"gauss": coords}, inds={"gauss": inds})
        last = ens.run_mcmc(state, 15, burn=5)

        nleaves = ens.get_nleaves()["gauss"]
        assert nleaves.shape == (15, ntemps, nwalkers)
        assert nleaves.min() >= 0 and nleaves.max() <= 8
        # cold chain stays near the injected 4 sources
        assert 2.0 < nleaves[:, 0].mean() <= 8.0
        assert np.isfinite(np.asarray(last.log_like)).all()

    def test_mt_rj_death_reduces_overfit(self):
        # start with ALL 8 leaves active: the 4 spurious ones should be
        # pruned quickly because the MT estimator sees the J-candidate
        # evidence for removal
        ntemps, nwalkers, ndim = 1, 16, 3
        rng = np.random.default_rng(11)
        y = jnp.asarray(_inject())

        def log_like(coords, inds, data, sigma):
            tmpl = _gauss_sum(coords, inds)
            return -0.5 * jnp.sum(((tmpl - data) / sigma) ** 2, axis=-1)

        gen = {"gauss": ProbDistContainer(GAUSS_PRIOR)}
        rj = MTDistGenMoveRJ(
            gen, num_try=6, nleaves_min={"gauss": 0}, nleaves_max={"gauss": 8}
        )
        ens = EnsembleSampler(
            16, {"gauss": ndim}, log_like, {"gauss": GAUSS_PRIOR},
            args=[y, SIGMA], branch_names=["gauss"],
            nleaves_max={"gauss": 8}, nleaves_min={"gauss": 0},
            moves=GaussianMove({"gauss": np.ones(ndim) * 1e-5}), rj_moves=[rj],
        )
        coords = np.zeros((ntemps, nwalkers, 8, ndim))
        for nn in range(8):
            src = GAUSS_INJ[nn % len(GAUSS_INJ)]
            coords[:, :, nn] = src + np.array([0.0, 0.3 * (nn // 4), 0.0])
            coords[:, :, nn] += 1e-3 * rng.standard_normal((ntemps, nwalkers, ndim))
        coords[..., 0] = np.clip(coords[..., 0], 2.51, 3.49)
        coords[..., 1] = np.clip(coords[..., 1], -0.99, 0.99)
        inds = np.ones((ntemps, nwalkers, 8), dtype=bool)
        state = make_state({"gauss": coords}, inds={"gauss": inds})
        ens.run_mcmc(state, 20)
        nleaves = ens.get_nleaves()["gauss"]
        # leaf count must drop from the saturated start
        assert nleaves[-5:].mean() < 8.0


class TestDelayedRejectionRJ:
    """Reference ``delayedrejection.py:31``: DR on rejected births."""

    def test_dr_rj_runs_and_improves_birth_acceptance(self):
        ntemps, nwalkers, ndim = 1, 16, 3
        rng = np.random.default_rng(13)
        y = jnp.asarray(_inject())

        def log_like(coords, inds, data, sigma):
            tmpl = _gauss_sum(coords, inds)
            return -0.5 * jnp.sum(((tmpl - data) / sigma) ** 2, axis=-1)

        def run(rj_move, seed=0):
            ens = EnsembleSampler(
                nwalkers, {"gauss": ndim}, log_like, {"gauss": GAUSS_PRIOR},
                args=[y, SIGMA], branch_names=["gauss"],
                nleaves_max={"gauss": 8}, nleaves_min={"gauss": 0},
                moves=GaussianMove({"gauss": np.ones(ndim) * 1e-5}),
                rj_moves=[rj_move], seed=seed,
            )
            coords, inds = _init_leaves(GAUSS_INJ, 8, ntemps, nwalkers, rng)
            state = make_state({"gauss": coords}, inds={"gauss": inds})
            ens.run_mcmc(state, 25)
            rj_acc = ens.backend.rj_acceptance_fraction
            nleaves = ens.get_nleaves()["gauss"]
            return rj_acc, nleaves

        gen = {"gauss": ProbDistContainer(GAUSS_PRIOR)}
        acc_dr, nl_dr = run(DelayedRejectionRJ(
            gen, nleaves_min={"gauss": 0}, nleaves_max={"gauss": 8}, max_iter=4
        ))
        acc_plain, nl_plain = run(DistributionGenerateRJ(
            gen, nleaves_min={"gauss": 0}, nleaves_max={"gauss": 8}
        ))
        # chains stay legal
        assert nl_dr.min() >= 0 and nl_dr.max() <= 8
        # more stages => at least as many trans-dimensional acceptances
        assert np.sum(acc_dr) >= np.sum(acc_plain)


class TestGroupAndDR:
    def test_group_stretch_samples_gaussian(self):
        ndim, nwalkers, ntemps = 2, 32, 1

        def log_like(x):
            return -0.5 * jnp.sum(x**2, axis=-1)

        priors = ProbDistContainer({i: uniform_dist(-6, 6) for i in range(ndim)})
        move = GroupStretchMove()
        rng = np.random.default_rng(5)
        friends = rng.standard_normal((64, ndim))
        move.set_friends(friends)

        ens = EnsembleSampler(nwalkers, ndim, log_like, priors, moves=move)
        coords = priors.rvs(size=(ntemps, nwalkers))
        ens.run_mcmc(coords[:, :, None, :], 150, burn=30)
        samples = ens.get_chain()["model_0"][:, 0].reshape(-1, ndim)
        assert abs(samples.mean()) < 0.2
        assert abs(samples.std() - 1.0) < 0.2

    def test_delayed_rejection_improves_acceptance(self):
        ndim, nwalkers, ntemps = 2, 32, 1

        def log_like(x):
            return -0.5 * jnp.sum(x**2, axis=-1)

        priors = ProbDistContainer({i: uniform_dist(-6, 6) for i in range(ndim)})
        coords = priors.rvs(size=(ntemps, nwalkers))

        def run(move, seed=11):
            ens = EnsembleSampler(
                nwalkers, ndim, log_like, priors, moves=move, seed=seed
            )
            ens.run_mcmc(coords[:, :, None, :], 120, burn=10)
            samples = ens.get_chain()["model_0"][:, 0].reshape(-1, ndim)
            return ens.acceptance_fraction.mean(), samples

        # oversized step: stage-2 shrink rescues rejections
        acc_dr, samples = run(DelayedRejectionMove(sigma=4.0, scale_2=0.1))
        acc_plain, _ = run(GaussianMove(16.0))  # cov = sigma^2
        assert acc_dr > acc_plain
        assert abs(samples.std() - 1.0) < 0.25

    def test_combine_move(self):
        ndim, nwalkers = 2, 16

        def log_like(x):
            return -0.5 * jnp.sum(x**2, axis=-1)

        priors = ProbDistContainer({i: uniform_dist(-6, 6) for i in range(ndim)})
        move = CombineMove([GaussianMove(0.25), GaussianMove(0.01)])
        ens = EnsembleSampler(nwalkers, ndim, log_like, priors, moves=move)
        coords = priors.rvs(size=(1, nwalkers))
        last = ens.run_mcmc(coords[:, :, None, :], 20)
        assert np.isfinite(np.asarray(last.log_like)).all()
