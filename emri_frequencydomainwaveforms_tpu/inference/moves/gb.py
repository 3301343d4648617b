"""Galactic-binary and legacy PT moves (lisatools ``sampling/moves/`` zoo).

Rebuilds the off-path move collection of the reference's
``LISAanalysistools/lisatools/sampling/moves/``:

* ``SkyMove`` (reference ``skymodehop.py:10``): discrete sky-mode hopping
  between the 8 degenerate LISA sky solutions — latitude reflection
  (sin beta -> -sin beta, cos iota -> -cos iota, psi -> pi - psi) and
  longitude quarter turns (lam, psi += k pi/2) — a symmetric MH proposal
  (factors = 0).
* ``MultiSourceFisherProposal`` (reference ``globalfish.py:79``): MH with a
  block-diagonal per-source covariance (one Fisher-derived block per
  source), global scale factor per walker.
* ``GBFreqJump`` (reference ``gbfreqjump.py:26``): in-model leaf update for
  multi-source GB states — one active leaf per walker gets ``num_try``
  candidates (relative-Gaussian perturbation, a ~20-frequency-bin f0 jump,
  prior redraw of the extrinsic subset, cosine reflection), selected by
  tempered likelihood. The reference accepts with ad-hoc
  ``-log p_sel`` factors (its own ``TODO: check this``); we use the proper
  independent-multiple-try estimator with the same candidate generator
  (symmetric-kernel I-MTM — exact when the generator is symmetric, which
  holds for all but the amplitude-relative term, as in the reference).
* ``BruteRejection`` / ``GBBruteRejectionRJ`` (reference
  ``bruterejection.py:22``, ``gbbruterejectionrj.py:25``): RJ births chosen
  from ``num_brute`` candidates weighted by exp(loglike) with detailed-
  balance factor ``-log p_sel`` — exactly the multiple-try RJ estimator, so
  this rebuild derives it from `MTDistGenMoveRJ` and adds the
  reference's knobs: ``take_max_ll`` (greedy search mode, detailed balance
  deliberately broken, as in the reference) and a ``point_generator_func``
  hook for search-sample libraries.
* ``PTRedBlueMove`` (reference ``ptredblue.py:8``): the legacy
  parallel-tempered red-blue driver (stretch within each rung + swap
  cascade + Vousden ladder adaptation) as one standalone object. The
  production path integrates the same pieces inside `EnsembleSampler`;
  this facade serves code written against the legacy API.

All moves follow this package's jittable propose contracts (flat
``(ntemps, nwalkers, ndim)`` or tree ``coords/inds`` dicts), so the
sampler can schedule them like any other move.
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .gaussian import MHMove
from .mt import MTDistGenMoveRJ
from .stretch import StretchMove
from .tempering import TemperatureControl


class SkyMove(MHMove):
    """Discrete sky-mode hopping MH (reference ``skymodehop.py:10``).

    ``ind_map``: dict with keys ``cosinc``, ``lam``, ``sinbeta``, ``psi``
    giving the parameter columns (defaults match the reference MBH layout).
    ``which``: "both" (default), "lat", or "long".
    """

    def __init__(self, ind_map: dict | None = None, which: str = "both",
                 periodic=None):
        super().__init__(periodic=periodic)
        if ind_map is None:
            ind_map = dict(cosinc=6, lam=7, sinbeta=8, psi=9)
        if which not in ("both", "lat", "long"):
            raise ValueError("which must be 'both', 'lat', or 'long'")
        self.ind_map = dict(ind_map)
        self.which = which

    def _lat(self, coords, flip):
        """Reflect across the LISA orbital plane: the (sin beta, cos iota,
        psi) triple maps to a degenerate mode. ``flip``: (T, W) bool."""
        m = self.ind_map
        f = flip[..., None]
        out = coords
        for col, new in (
            (m["sinbeta"], -coords[..., m["sinbeta"]]),
            (m["cosinc"], -coords[..., m["cosinc"]]),
            (m["psi"], np.pi - coords[..., m["psi"]]),
        ):
            out = out.at[..., col].set(
                jnp.where(f[..., 0], new, out[..., col])
            )
        return out

    def _long(self, coords, k):
        """Quarter-turn longitude modes: lam, psi += k pi/2 (k in 0..3)."""
        m = self.ind_map
        shift = k.astype(coords.dtype) * (np.pi / 2.0)
        psi = jnp.mod(coords[..., m["psi"]] + shift, np.pi)
        lam = jnp.mod(coords[..., m["lam"]] + shift, 2 * np.pi)
        return coords.at[..., m["psi"]].set(psi).at[..., m["lam"]].set(lam)

    def get_proposal(self, key, coords):
        ntemps, nwalkers, _ = coords.shape
        k_flip, k_turn = jax.random.split(key)
        prop = coords
        if self.which in ("both", "lat"):
            flip = (
                jax.random.bernoulli(k_flip, 0.5, (ntemps, nwalkers))
                if self.which == "both"
                else jnp.ones((ntemps, nwalkers), bool)
            )
            prop = self._lat(prop, flip)
        if self.which in ("both", "long"):
            k = jax.random.randint(k_turn, (ntemps, nwalkers), 0, 4)
            prop = self._long(prop, k)
        # involution (lat) x uniform group shift (long): symmetric, factors 0
        return prop, jnp.zeros((ntemps, nwalkers))


class MultiSourceFisherProposal(MHMove):
    """Block-diagonal Fisher-covariance MH (reference ``globalfish.py:79``).

    ``cov``: (nsystems, d, d) stack of per-source covariance blocks (or a
    list of (d, d) arrays); the sampled vector is the concatenation of the
    per-source parameter blocks, ndim = nsystems * d. ``factor`` scales all
    blocks (the reference's per-walker adaptive factor is initialized
    constant and its adaptation is disabled upstream; we keep the constant).
    """

    def __init__(self, cov, factor: float = 1.0, periodic=None):
        super().__init__(periodic=periodic)
        cov = np.asarray(cov, dtype=np.float64)
        if cov.ndim == 2:
            cov = cov[None]
        self.nsystems, self.d, _ = cov.shape
        self._chols = np.linalg.cholesky(cov)  # (S, d, d)
        self.factor = float(factor)

    def get_proposal(self, key, coords):
        ntemps, nwalkers, ndim = coords.shape
        if ndim != self.nsystems * self.d:
            raise ValueError(
                f"ndim {ndim} != nsystems*d {self.nsystems * self.d}"
            )
        z = jax.random.normal(key, (ntemps, nwalkers, self.nsystems, self.d))
        chol = jnp.asarray(self._chols) * math.sqrt(self.factor)
        step = jnp.einsum("sij,twsj->twsi", chol, z)
        prop = coords + step.reshape(ntemps, nwalkers, ndim)
        return prop, jnp.zeros((ntemps, nwalkers))


class GBFreqJump:
    """Multi-try frequency-jump leaf update (reference ``gbfreqjump.py:26``).

    Tree-contract in-model move: per walker, one uniformly-chosen ACTIVE
    leaf gets ``num_try`` candidates built from the current leaf by

    * relative Gaussian perturbation ``x += x * factor * N(0,1)`` on all
      params (reference :97),
    * the f0 column's (``f0_ind``, default 1, mHz units) perturbation
      replaced by ``20 * df * 1e3 * N(0,1)`` — a multi-frequency-bin jump
      (reference :99),
    * a fresh prior draw for the ``prior_redraw`` columns (default
      (2, 3, 4, 5): fdot, phi0, cos iota, psi — reference :107-109),
    * reflection of the ``reflect_inds`` cosine columns into [-1, 1]
      (reference :102-105),

    then selects one candidate by tempered likelihood and accepts with the
    symmetric-kernel I-MTM ratio (see module docstring for the deliberate
    deviation from the reference's ad-hoc factors).
    """

    def __init__(self, df: float, factor: float, *, num_try: int = 10,
                 f0_ind: int = 1, prior_redraw=(2, 3, 4, 5),
                 reflect_inds=(4, 7), priors=None, spread: int = 20):
        self.df = float(df)
        self.factor = float(factor)
        self.num_try = int(num_try)
        self.f0_ind = int(f0_ind)
        self.prior_redraw = tuple(prior_redraw)
        self.reflect_inds = tuple(reflect_inds)
        self.priors = priors  # ProbDistContainer or dict branch -> container
        self.spread = float(spread)

    def _candidates(self, key, leaf, prior, ndim):
        """(T, W, D) current leaf -> (T, W, J, D) candidate cloud."""
        t, w, _ = leaf.shape
        j = self.num_try
        k_rel, k_f0, k_pr = jax.random.split(key, 3)
        base = jnp.broadcast_to(leaf[:, :, None, :], (t, w, j, ndim))
        cand = base * (1.0 + self.factor * jax.random.normal(k_rel, base.shape))
        f0_step = self.spread * self.df * 1e3 * jax.random.normal(
            k_f0, (t, w, j)
        )
        cand = cand.at[..., self.f0_ind].set(
            base[..., self.f0_ind] + f0_step
        )
        if prior is not None and self.prior_redraw:
            u = jax.random.uniform(k_pr, (t, w, j, len(self.prior_redraw)))
            for n, col in enumerate(self.prior_redraw):
                d = prior.priors_in[col]
                cand = cand.at[..., col].set(d.ppf(u[..., n]))
        for col in self.reflect_inds:
            x = cand[..., col]
            x = jnp.where(x > 1.0, x - 2.0 * jnp.abs(1.0 - x), x)
            x = jnp.where(x < -1.0, x + 2.0 * jnp.abs(-1.0 - x), x)
            cand = cand.at[..., col].set(x)
        return cand

    def propose_tree(self, key, coords: dict, inds: dict, log_like, log_prior,
                     betas, logp_fn, logl_fn):
        priors = self.priors if isinstance(self.priors, dict) else {
            name: self.priors for name in coords
        }
        n_acc_total = None
        coords = dict(coords)
        inds = dict(inds)
        for name in coords:
            key, k_b = jax.random.split(key)

            def logl_branch(c_b, i_b, _name=name):
                return logl_fn({**coords, _name: c_b}, {**inds, _name: i_b})

            def logp_branch(c_b, i_b, _name=name):
                return logp_fn({**coords, _name: c_b}, {**inds, _name: i_b})

            c_new, log_like, log_prior, n_acc = self._propose_branch(
                k_b, priors[name], coords[name], inds[name],
                log_like, log_prior, betas, logl_branch, logp_branch,
            )
            coords[name] = c_new
            n_acc_total = n_acc if n_acc_total is None else n_acc_total + n_acc
        return coords, inds, log_like, log_prior, n_acc_total

    # the ensemble schedules in-model tree moves through `propose` with the
    # same (key, coords, inds, ...) signature
    propose = propose_tree

    def _propose_branch(self, key, prior, coords, inds, log_like, log_prior,
                        betas, logl_fn, logp_fn):
        ntemps, nwalkers, nlmax, ndim = coords.shape
        j = self.num_try
        k_slot, k_cand, k_sel, k_u = jax.random.split(key, 4)

        # one uniformly-chosen active leaf per walker (Gumbel trick over the
        # active mask; walkers with no active leaf propose nothing)
        u_slot = jax.random.uniform(k_slot, (ntemps, nwalkers, nlmax))
        any_active = jnp.any(inds, axis=-1)
        slot = jnp.argmax(jnp.where(inds, u_slot, -jnp.inf), axis=-1)
        onehot = jax.nn.one_hot(slot, nlmax, dtype=bool)

        leaf = jnp.take_along_axis(coords, slot[..., None, None], axis=2)[
            :, :, 0, :
        ]
        cand = self._candidates(k_cand, leaf, prior, ndim)  # (T, W, J, D)

        # fold J into the walker axis for ONE batched likelihood call
        put = onehot[:, :, None, :, None]
        coords_j = jnp.where(
            put, cand[:, :, :, None, :],
            jnp.broadcast_to(coords[:, :, None], (ntemps, nwalkers, j, nlmax, ndim)),
        )
        inds_j = jnp.broadcast_to(inds[:, :, None], (ntemps, nwalkers, j, nlmax))
        ll_j = logl_fn(
            coords_j.reshape(ntemps, nwalkers * j, nlmax, ndim),
            inds_j.reshape(ntemps, nwalkers * j, nlmax),
        ).reshape(ntemps, nwalkers, j)
        lp_j = logp_fn(
            coords_j.reshape(ntemps, nwalkers * j, nlmax, ndim),
            inds_j.reshape(ntemps, nwalkers * j, nlmax),
        ).reshape(ntemps, nwalkers, j)
        ll_j = jnp.where(jnp.isnan(ll_j), -1e300, ll_j)
        ll_j = jnp.where(jnp.isfinite(lp_j), ll_j, -1e300)

        logw = betas[:, None, None] * ll_j + lp_j
        logw = jnp.where(jnp.isfinite(logw), logw, -jnp.inf)
        g = -jnp.log(-jnp.log(jax.random.uniform(k_sel, logw.shape)))
        sel = jnp.argmax(logw + g, axis=-1)

        take = lambda arr: jnp.take_along_axis(arr, sel[..., None], axis=-1)[..., 0]
        y = jnp.take_along_axis(cand, sel[..., None, None], axis=2)[..., 0, :]
        ll_y, lp_y = take(ll_j), take(lp_j)

        # symmetric-kernel I-MTM: current point replaces the selected draw
        logw_x = betas[:, None] * log_like + log_prior
        num = jax.nn.logsumexp(logw, axis=-1)
        logw_masked = jnp.where(
            jnp.arange(j)[None, None, :] == sel[..., None], -jnp.inf, logw
        )
        den = jnp.logaddexp(jax.nn.logsumexp(logw_masked, axis=-1), logw_x)

        accept = jnp.log(jax.random.uniform(k_u, (ntemps, nwalkers))) < num - den
        accept = accept & any_active & jnp.isfinite(lp_y)

        coords = jnp.where(
            (accept[..., None] & onehot)[..., None], y[..., None, :], coords
        )
        log_like = jnp.where(accept, ll_y, log_like)
        log_prior = jnp.where(accept, lp_y, log_prior)
        return coords, log_like, log_prior, jnp.sum(accept, axis=1).astype(jnp.int32)


class BruteRejectionRJ(MTDistGenMoveRJ):
    """Brute-force-rejection RJ births (reference ``bruterejection.py:22``,
    ``gbbruterejectionrj.py:25``).

    The reference's "brute rejection" — draw ``num_brute`` candidate births,
    evaluate each likelihood, select ~ softmax(ll), carry ``-log p_sel`` as
    the detailed-balance factor — is the multiple-try RJ estimator, so this
    derives from `MTDistGenMoveRJ` and adds the reference's knobs:

    * ``num_brute``: candidate-cloud size (alias of ``num_try``);
    * ``take_max_ll``: greedy argmax selection with zero selection factor
      (search mode; deliberately breaks detailed balance, reference :85-88);
    * ``point_generator_func(key, shape) -> (candidates, logq)``: custom
      birth generator replacing prior draws (the reference's search-sample
      library path, ``gbbruterejectionrj.py:112-120``). As in the reference
      (zero ``generate_factors`` for search samples), the returned ``logq``
      is not folded into the weights — candidates are density-weighted by
      the prior logpdf.
    """

    def __init__(self, generate_dist, num_brute: int = 10, *,
                 take_max_ll: bool = False, point_generator_func=None,
                 nleaves_min=0, nleaves_max=1, **kwargs):
        super().__init__(generate_dist, num_try=num_brute,
                         nleaves_min=nleaves_min, nleaves_max=nleaves_max,
                         **kwargs)
        self.num_brute = int(num_brute)
        self.take_max_ll = bool(take_max_ll)
        # greedy search mode: argmax selection (parent checks this flag);
        # the acceptance estimator is left unchanged — detailed balance is
        # deliberately broken, exactly the reference's search semantics
        self._greedy_select = bool(take_max_ll)
        self.point_generator_func = point_generator_func

    def _draw(self, dist, key, shape):
        if self.point_generator_func is not None:
            cand, _logq = self.point_generator_func(key, shape)
            return jnp.asarray(cand)
        return super()._draw(dist, key, shape)


class GBBruteRejectionRJ(BruteRejectionRJ):
    """Alias carrying the reference's GB-flavored name
    (``gbbruterejectionrj.py:25``); the data/PSD plumbing the reference
    embeds here lives in `lisa.likelihood.GlobalLikelihood` in this package."""


class PTRedBlueMove:
    """Legacy parallel-tempered red-blue driver (reference ``ptredblue.py:8``).

    One object bundling what `EnsembleSampler` integrates natively: a
    Goodman-Weare stretch within every temperature rung, the nearest-
    neighbor swap cascade, and Vousden ladder adaptation. ``propose``
    mutates the ladder (host-side state, like the reference's ``self.betas``)
    and returns it with the updated ensemble.
    """

    def __init__(self, betas, nwalkers: int, ndim: int, *, adaptive=True,
                 nsplits: int = 2, randomize_split: bool = False,
                 live_dangerously: bool = False, adaptation_lag=10000,
                 adaptation_time=100, stop_adaptation: int = -1,
                 a: float = 2.0, periodic=None):
        del nsplits, randomize_split  # the stretch handles its own split
        self.betas = np.asarray(betas, dtype=np.float64)
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        if nwalkers < 2 * ndim and not live_dangerously:
            raise RuntimeError(
                "red-blue moves need nwalkers >= 2*ndim "
                "(pass live_dangerously=True to override)"
            )
        self.stretch = StretchMove(a=a, periodic=periodic)
        self.control = TemperatureControl(
            ndim, nwalkers, ntemps=len(self.betas), betas=self.betas,
            adaptive=adaptive, adaptation_lag=adaptation_lag,
            adaptation_time=adaptation_time, stop_adaptation=stop_adaptation,
        )
        self.stop_adaptation = stop_adaptation
        self.time = 0
        self.swaps_accepted = np.zeros(max(len(self.betas) - 1, 0))

    def propose(self, key, coords, log_like, log_prior, logp_fn, logl_fn):
        """One PT red-blue iteration.

        Returns (coords, log_like, log_prior, n_accepted, betas).
        """
        betas = jnp.asarray(self.betas)
        key, k_move, k_swap = jax.random.split(key, 3)
        coords, log_like, log_prior, n_acc = self.stretch.propose(
            k_move, coords, log_like, log_prior, betas, logp_fn, logl_fn
        )
        coords, log_like, log_prior, swap_frac = self.control.temperature_swaps(
            k_swap, coords, log_like, log_prior, betas
        )
        if len(self.betas) > 1:
            self.swaps_accepted += np.asarray(swap_frac)
            if self.stop_adaptation < 0 or self.time < self.stop_adaptation:
                betas = self.control.adapt_ladder(betas, swap_frac, self.time)
                self.betas = np.asarray(betas)
        self.time += 1
        return coords, log_like, log_prior, n_acc, jnp.asarray(self.betas)


__all__ = [
    "SkyMove",
    "MultiSourceFisherProposal",
    "GBFreqJump",
    "BruteRejection",
    "BruteRejectionRJ",
    "GBBruteRejectionRJ",
    "PTRedBlueMove",
]

# reference ``bruterejection.py:22`` name for the selection core
BruteRejection = BruteRejectionRJ
