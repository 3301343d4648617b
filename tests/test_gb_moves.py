"""Galactic-binary / legacy move-zoo tests.

Covers the JAX rebuilds of the reference's
``LISAanalysistools/lisatools/sampling/moves/`` collection
(``skymodehop.py:10`` SkyMove, ``globalfish.py:79``
MultiSourceFisherProposal, ``gbfreqjump.py:26`` GBFreqJump,
``bruterejection.py:22`` / ``gbbruterejectionrj.py:25`` BruteRejectionRJ,
``ptredblue.py:8`` PTRedBlueMove) with statistical checks the reference
scripts lack.
"""

import numpy as np
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.inference import (
    EnsembleSampler,
    GaussianMove,
    ProbDistContainer,
    make_state,
    uniform_dist,
)
from emri_frequencydomainwaveforms_tpu.inference.moves.gb import (
    BruteRejectionRJ,
    GBFreqJump,
    MultiSourceFisherProposal,
    PTRedBlueMove,
    SkyMove,
)


class TestSkyMove:
    def test_lat_is_involution(self):
        """Applying the latitude reflection twice restores the state."""
        move = SkyMove(which="lat")
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.uniform(-1, 1, (2, 8, 11)))
        key = jax.random.PRNGKey(0)
        once, f1 = move.get_proposal(key, x)
        twice, _ = move.get_proposal(key, once)
        np.testing.assert_allclose(np.asarray(twice), np.asarray(x), atol=1e-13)
        assert np.all(np.asarray(f1) == 0.0)

    def test_long_stays_in_range(self):
        move = SkyMove(which="long")
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.uniform(0, 1, (1, 64, 11)))
        prop, _ = move.get_proposal(jax.random.PRNGKey(1), x)
        prop = np.asarray(prop)
        assert (prop[..., 9] >= 0).all() and (prop[..., 9] < np.pi).all()
        assert (prop[..., 7] >= 0).all() and (prop[..., 7] < 2 * np.pi).all()

    def test_mode_hopping_explores_reflected_mode(self):
        """On a target symmetric under the sky reflection, the chain must
        occupy both sinbeta signs (this is exactly what the move is for)."""
        ndim = 11

        def logl(x):
            return -0.5 * (
                (jnp.abs(x[:, 8]) - 0.5) ** 2 + (jnp.abs(x[:, 6]) - 0.5) ** 2
            ) / 0.01

        def logp(x):
            ok = (jnp.abs(x[:, 8]) < 1.0) & (jnp.abs(x[:, 6]) < 1.0)
            return jnp.where(ok, 0.0, -jnp.inf)

        move = SkyMove(which="both")
        ntemps, nwalkers = 1, 32
        rng = np.random.default_rng(2)
        coords = jnp.asarray(rng.uniform(0.45, 0.55, (ntemps, nwalkers, ndim)))
        ll = logl(coords.reshape(-1, ndim)).reshape(ntemps, nwalkers)
        lp = logp(coords.reshape(-1, ndim)).reshape(ntemps, nwalkers)
        betas = jnp.ones((ntemps,))
        key = jax.random.PRNGKey(3)
        signs = []
        for _ in range(20):
            key, k = jax.random.split(key)
            coords, ll, lp, n_acc = move.propose(
                k, coords, ll, lp, betas, logp, logl
            )
            signs.append(np.sign(np.asarray(coords[0, :, 8])))
        signs = np.concatenate(signs)
        # symmetric target: both reflected modes visited, roughly evenly
        assert (signs > 0).mean() > 0.2 and (signs < 0).mean() > 0.2


class TestMultiSourceFisher:
    def test_block_cov_sampling_matches_target(self):
        """2 sources x 2 params; proposal blocks = target blocks: the MH
        chain must reproduce the product-Gaussian target moments."""
        blocks = np.array(
            [[[0.04, 0.015], [0.015, 0.02]], [[0.09, -0.02], [-0.02, 0.05]]]
        )
        prec = np.linalg.inv(blocks)

        def logl(x):
            x0 = x[:, :2]
            x1 = x[:, 2:]
            q0 = jnp.einsum("wi,ij,wj->w", x0, jnp.asarray(prec[0]), x0)
            q1 = jnp.einsum("wi,ij,wj->w", x1, jnp.asarray(prec[1]), x1)
            return -0.5 * (q0 + q1)

        logp = lambda x: jnp.zeros(x.shape[0])
        move = MultiSourceFisherProposal(blocks, factor=1.2)
        ntemps, nwalkers, ndim = 1, 64, 4
        rng = np.random.default_rng(5)
        coords = jnp.asarray(0.1 * rng.standard_normal((ntemps, nwalkers, ndim)))
        ll = logl(coords.reshape(-1, ndim)).reshape(ntemps, nwalkers)
        lp = jnp.zeros((ntemps, nwalkers))
        betas = jnp.ones((1,))

        @jax.jit
        def run(key, coords, ll, lp):
            def body(carry, k):
                c, l1, l2 = carry
                c, l1, l2, na = move.propose(k, c, l1, l2, betas, logp, logl)
                return (c, l1, l2), c

            keys = jax.random.split(key, 600)
            (coords, ll, lp), hist = jax.lax.scan(body, (coords, ll, lp), keys)
            return hist

        hist = np.asarray(run(jax.random.PRNGKey(7), coords, ll, lp))
        flat = hist[200:].reshape(-1, ndim)
        emp = np.cov(flat.T)
        target = np.zeros((4, 4))
        target[:2, :2] = blocks[0]
        target[2:, 2:] = blocks[1]
        # diagonal variances within 25%, cross-block correlations ~ 0
        np.testing.assert_allclose(np.diag(emp), np.diag(target), rtol=0.25)
        assert np.abs(emp[0, 2]) < 0.02 and np.abs(emp[1, 3]) < 0.02


GB_NDIM = 8
GB_CENTER = np.array([1.0, 3.0, 0.2, 0.4, 0.3, 0.6, 0.7, -0.2])
GB_PRIOR = {i: uniform_dist(-5.0, 5.0) for i in range(GB_NDIM)}


def _gb_logl(coords, inds):
    """Masked per-leaf Gaussian bump around GB_CENTER."""
    d2 = jnp.sum((coords - jnp.asarray(GB_CENTER)) ** 2, axis=-1)
    per_leaf = -0.5 * d2 / 0.05**2
    return jnp.sum(jnp.where(inds, per_leaf, 0.0), axis=-1)


class TestGBFreqJump:
    def test_leaf_update_improves_likelihood(self):
        ntemps, nwalkers, nlmax = 1, 16, 2
        rng = np.random.default_rng(11)
        prior = ProbDistContainer(GB_PRIOR)
        move = GBFreqJump(df=1e-4, factor=0.02, num_try=8, priors=prior,
                          prior_redraw=(2, 3), reflect_inds=(4, 7))

        coords = jnp.asarray(
            GB_CENTER + 0.3 * rng.standard_normal((ntemps, nwalkers, nlmax, GB_NDIM))
        )
        inds = jnp.ones((ntemps, nwalkers, nlmax), bool).at[:, :, 1].set(False)
        logp_fn = lambda c, i: jnp.sum(
            jnp.where(i, prior.logpdf(c), 0.0), axis=-1
        )
        logl_fn = _gb_logl
        ll = logl_fn(coords, inds)
        lp = logp_fn(coords, inds)
        betas = jnp.ones((1,))
        key = jax.random.PRNGKey(13)
        ll0 = float(jnp.mean(ll))
        for _ in range(15):
            key, k = jax.random.split(key)
            coords, inds_out, ll, lp, n_acc = move.propose_tree(
                k, {"gb": coords}, {"gb": inds}, ll, lp, betas,
                lambda cd, id_: logp_fn(cd["gb"], id_["gb"]),
                lambda cd, id_: logl_fn(cd["gb"], id_["gb"]),
            )
            coords = coords["gb"]
            # in-model move: the leaf mask must never change
            np.testing.assert_array_equal(
                np.asarray(inds_out["gb"]), np.asarray(inds)
            )
        assert float(jnp.mean(ll)) > ll0
        assert np.isfinite(np.asarray(ll)).all()

    def test_inactive_walkers_never_accept(self):
        prior = ProbDistContainer(GB_PRIOR)
        move = GBFreqJump(df=1e-4, factor=0.05, num_try=4, priors=prior,
                          prior_redraw=(2, 3), reflect_inds=())
        ntemps, nwalkers, nlmax = 1, 8, 2
        coords = jnp.zeros((ntemps, nwalkers, nlmax, GB_NDIM))
        inds = jnp.zeros((ntemps, nwalkers, nlmax), bool)
        ll = jnp.zeros((ntemps, nwalkers))
        lp = jnp.zeros((ntemps, nwalkers))
        out_c, _, out_ll, _, n_acc = move.propose_tree(
            jax.random.PRNGKey(0), {"gb": coords}, {"gb": inds}, ll, lp,
            jnp.ones((1,)),
            lambda cd, id_: jnp.zeros(cd["gb"].shape[:2]),
            lambda cd, id_: jnp.zeros(cd["gb"].shape[:2]),
        )
        assert int(jnp.sum(n_acc)) == 0
        np.testing.assert_array_equal(np.asarray(out_c["gb"]), np.asarray(coords))


class TestBruteRejectionRJ:
    def _setup(self, take_max_ll):
        from tests.test_eryn_rj import (
            GAUSS_PRIOR,
            GAUSS_INJ,
            SIGMA,
            _gauss_sum,
            _inject,
            _init_leaves,
        )

        ntemps, nwalkers, ndim = 1, 16, 3
        rng = np.random.default_rng(17)
        y = jnp.asarray(_inject())

        def log_like(coords, inds, data, sigma):
            tmpl = _gauss_sum(coords, inds)
            return -0.5 * jnp.sum(((tmpl - data) / sigma) ** 2, axis=-1)

        gen = {"gauss": ProbDistContainer(GAUSS_PRIOR)}
        rj = BruteRejectionRJ(
            gen, num_brute=6, take_max_ll=take_max_ll,
            nleaves_min={"gauss": 0}, nleaves_max={"gauss": 8},
        )
        ens = EnsembleSampler(
            nwalkers, {"gauss": ndim}, log_like, {"gauss": GAUSS_PRIOR},
            args=[y, SIGMA], branch_names=["gauss"],
            nleaves_max={"gauss": 8}, nleaves_min={"gauss": 0},
            moves=GaussianMove({"gauss": np.ones(ndim) * 1e-5}), rj_moves=[rj],
        )
        coords, inds = _init_leaves(GAUSS_INJ, 8, ntemps, nwalkers, rng)
        state = make_state({"gauss": coords}, inds={"gauss": inds})
        return ens, state

    def test_brute_rejection_rj_leaf_counts(self):
        ens, state = self._setup(take_max_ll=False)
        last = ens.run_mcmc(state, 12, burn=3)
        nl = ens.get_nleaves()["gauss"]
        assert nl.min() >= 0 and nl.max() <= 8
        assert 2.0 < nl[:, 0].mean() <= 8.0
        assert np.isfinite(np.asarray(last.log_like)).all()

    def test_greedy_search_mode_runs(self):
        ens, state = self._setup(take_max_ll=True)
        last = ens.run_mcmc(state, 5)
        assert np.isfinite(np.asarray(last.log_like)).all()

    def test_point_generator_hook(self):
        gen = ProbDistContainer(
            {0: uniform_dist(-1.0, 1.0), 1: uniform_dist(-1.0, 1.0)}
        )

        lib = np.array([[0.5, 0.5], [-0.5, -0.5], [0.1, 0.2]])

        def from_library(key, shape):
            idx = jax.random.randint(key, shape[:-1], 0, len(lib))
            return jnp.asarray(lib)[idx], jnp.zeros(shape[:-1])

        rj = BruteRejectionRJ(
            gen, num_brute=4, point_generator_func=from_library,
            nleaves_min=0, nleaves_max=3,
        )
        cand = rj._draw(gen, jax.random.PRNGKey(0), (2, 4, 4, 2))
        assert cand.shape == (2, 4, 4, 2)
        flat = np.asarray(cand).reshape(-1, 2)
        # every candidate comes from the library
        dists = np.min(
            np.linalg.norm(flat[:, None, :] - lib[None], axis=-1), axis=1
        )
        assert dists.max() < 1e-12


class TestPTRedBlue:
    def test_pt_driver_samples_and_adapts(self):
        ndim, nwalkers, ntemps = 2, 16, 3

        def logl(x):
            return -0.5 * jnp.sum(x**2, axis=-1) / 0.3**2

        def logp(x):
            ok = jnp.all(jnp.abs(x) < 5.0, axis=-1)
            return jnp.where(ok, 0.0, -jnp.inf)

        betas0 = np.array([1.0, 0.3, 0.05])
        move = PTRedBlueMove(betas0, nwalkers, ndim, adaptive=True)
        rng = np.random.default_rng(23)
        coords = jnp.asarray(0.3 * rng.standard_normal((ntemps, nwalkers, ndim)))
        ll = logl(coords.reshape(-1, ndim)).reshape(ntemps, nwalkers)
        lp = logp(coords.reshape(-1, ndim)).reshape(ntemps, nwalkers)
        key = jax.random.PRNGKey(29)
        hist = []
        for _ in range(150):
            key, k = jax.random.split(key)
            coords, ll, lp, n_acc, betas = move.propose(
                k, coords, ll, lp, logp, logl
            )
            hist.append(np.asarray(coords[0]))
        cold = np.concatenate(hist[50:], axis=0)
        # cold-chain std matches the 0.3 target within 20%
        np.testing.assert_allclose(cold.std(axis=0), 0.3, rtol=0.2)
        # the middle rung moved (Vousden adaptation active)
        assert abs(move.betas[1] - betas0[1]) > 1e-6
        assert move.betas[0] == 1.0
        assert move.time == 150

    def test_walker_guard(self):
        import pytest

        with pytest.raises(RuntimeError):
            PTRedBlueMove(np.array([1.0]), nwalkers=4, ndim=8)
