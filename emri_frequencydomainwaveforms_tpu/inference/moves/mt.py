"""Multiple-try Metropolis with independent distribution draws (jittable).

Rebuilds Eryn's ``MTDistGenMove`` (reference
``Eryn/eryn/moves/multipletry.py:36`` vectorized multiple-try with
logsumexp weights at :25; independence-sampler variant
``mtdistgen.py:7``): per walker, draw ``num_try`` candidates from a fixed
distribution q, weight each by the tempered posterior over q, select one
with probability proportional to its weight, and accept with the
multiple-try ratio

  alpha = sum_j w(y_j) / ( sum_{j != I} w(y_j) + w(x) ),

which for independent draws needs no second candidate cloud (the reverse
cloud reuses the forward draws with the current point swapped in for the
selected candidate — the standard I-MTM estimator).

Shape: all ``(ntemps, nwalkers, num_try)`` candidates evaluate
in ONE batched likelihood call; selection is a Gumbel-max over log
weights (no per-walker loops).
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp


class MTDistGenMove:
    """Independent multiple-try Metropolis from a ProbDistContainer."""

    def __init__(self, generate_dist, num_try: int = 10, independent: bool = True,
                 rj: bool = False, **kwargs):
        del kwargs
        if not independent:
            raise NotImplementedError("only independent proposal MT is implemented")
        self.dist = generate_dist
        self.num_try = int(num_try)
        self.rj = rj

    def _draw(self, key, shape):
        """Unit-cube ppf draws -> candidate coordinates, + their log q."""
        u = jax.random.uniform(key, shape)
        cols = []
        for i in range(shape[-1]):
            d = self.dist.priors_in[i]
            cols.append(d.ppf(u[..., i]))
        x = jnp.stack(cols, axis=-1)
        logq = self.dist.logpdf(x)
        return x, logq

    def propose(
        self,
        key: jax.Array,
        coords: jax.Array,  # (ntemps, nwalkers, ndim)
        log_like: jax.Array,  # (ntemps, nwalkers)
        log_prior: jax.Array,
        betas: jax.Array,
        logp_fn: Callable,
        logl_fn: Callable,
    ):
        ntemps, nwalkers, ndim = coords.shape
        j = self.num_try
        key, k_draw, k_sel, k_u = jax.random.split(key, 4)

        cands, logq = self._draw(k_draw, (ntemps, nwalkers, j, ndim))
        flat = cands.reshape(-1, ndim)
        lp_c = logp_fn(flat).reshape(ntemps, nwalkers, j)
        ll_c = logl_fn(flat).reshape(ntemps, nwalkers, j)
        ll_c = jnp.where(jnp.isnan(ll_c), -1e300, ll_c)
        ll_c = jnp.where(jnp.isfinite(lp_c), ll_c, -1e300)

        # log importance weights: tempered posterior over the draw density
        logw = betas[:, None, None] * ll_c + lp_c - logq
        logw = jnp.where(jnp.isfinite(logw), logw, -jnp.inf)

        # Gumbel-max selection ~ categorical(softmax(logw))
        g = -jnp.log(-jnp.log(jax.random.uniform(k_sel, logw.shape)))
        sel = jnp.argmax(logw + g, axis=-1)  # (T, W)

        take = lambda arr: jnp.take_along_axis(arr, sel[..., None], axis=-1)[..., 0]
        y = jnp.take_along_axis(cands, sel[..., None, None], axis=2)[..., 0, :]
        ll_y = take(ll_c)
        lp_y = take(lp_c)

        # current point's weight under the same scheme
        logq_x = self.dist.logpdf(coords)
        logw_x = betas[:, None] * log_like + log_prior - logq_x
        logw_x = jnp.where(jnp.isfinite(logw_x), logw_x, -jnp.inf)

        num = jax.nn.logsumexp(logw, axis=-1)
        # denominator: forward cloud with x replacing the selected draw
        logw_masked = jnp.where(
            jnp.arange(j)[None, None, :] == sel[..., None], -jnp.inf, logw
        )
        den = jnp.logaddexp(jax.nn.logsumexp(logw_masked, axis=-1), logw_x)

        lnpdiff = num - den
        accept = jnp.log(jax.random.uniform(k_u, (ntemps, nwalkers))) < lnpdiff
        accept = accept & jnp.isfinite(lp_y)

        coords = jnp.where(accept[..., None], y, coords)
        log_like = jnp.where(accept, ll_y, log_like)
        log_prior = jnp.where(accept, lp_y, log_prior)
        return coords, log_like, log_prior, jnp.sum(accept, axis=1).astype(jnp.int32)


class MTDistGenMoveRJ:
    """Reversible-jump multiple-try with independent distribution draws.

    Rebuilds Eryn's ``MTDistGenMoveRJ`` (reference
    ``Eryn/eryn/moves/mtdistgenrj.py:7`` over the ``MultipleTryMoveRJ``
    machinery at ``multipletry.py:580``): every walker proposes a birth or
    death; both are evaluated as a *pretend birth* against the REDUCED state
    (the walker without the leaf in question):

    * birth: draw ``num_try`` candidate leaves from q, weight
      ``log w_j = beta ll_j + lp_j - log q_j - lp_red`` (the reference adds
      ``lp_in`` to the proposal pdf so existing leaves' priors cancel,
      ``multipletry.py:316-318``), select one ~ softmax(w) (Gumbel-max), and
      accept with ``logsumexp(w) - beta ll_red - log J`` — the I-MTM
      estimator of the birth ratio (reference factors algebra,
      ``multipletry.py:455-460`` collapsed with logP_new - logP_old);
    * death: the same cloud with the REAL leaf occupying try 0 and the
      selection forced to 0 (reference ``fill_tuple``/``inds_reverse_rj``),
      accepted with the NEGATED estimator.

    Slot-choice combinatorics (uniform among inactive/active slots) are
    included as in `DistributionGenerateRJ`. Branches are updated
    sequentially (Gibbs), matching the one-branch-at-a-time restriction of
    the reference (``multipletry.py:612``).
    """

    def __init__(self, generate_dist, num_try: int = 10, nleaves_min=0,
                 nleaves_max=1, **kwargs):
        del kwargs
        self.dist = generate_dist  # ProbDistContainer or dict of them
        self.num_try = int(num_try)
        self.nleaves_min = nleaves_min
        self.nleaves_max = nleaves_max

    def _draw(self, dist, key, shape):
        u = jax.random.uniform(key, shape)
        cols = []
        for i in range(shape[-1]):
            d = dist.priors_in[i]
            cols.append(d.ppf(u[..., i]))
        return jnp.stack(cols, axis=-1)

    def propose_tree(self, key, coords: dict, inds: dict, log_like, log_prior,
                     betas, logp_fn, logl_fn):
        dists = self.dist if isinstance(self.dist, dict) else {
            name: self.dist for name in coords
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

            lo = self.nleaves_min[name] if isinstance(self.nleaves_min, dict) else self.nleaves_min
            hi = self.nleaves_max[name] if isinstance(self.nleaves_max, dict) else self.nleaves_max
            c_new, i_new, log_like, log_prior, n_acc = self._propose_branch(
                k_b, dists[name], lo, hi, coords[name], inds[name],
                log_like, log_prior, betas, logl_branch, logp_branch,
            )
            coords[name] = c_new
            inds[name] = i_new
            n_acc_total = n_acc if n_acc_total is None else n_acc_total + n_acc
        return coords, inds, log_like, log_prior, n_acc_total

    def _propose_branch(self, key, dist, nleaves_min, nleaves_max, coords, inds,
                        log_like, log_prior, betas, logl_fn, logp_fn):
        ntemps, nwalkers, nlmax, ndim = coords.shape
        jtry = self.num_try
        k_bd, k_slot, k_draw, k_sel, k_u = jax.random.split(key, 5)

        # ---- birth/death decision + slot (as in DistributionGenerateRJ) ----
        n_active = jnp.sum(inds, axis=-1)
        can_birth = n_active < nleaves_max
        can_death = n_active > nleaves_min
        do_birth = jnp.where(
            can_birth & can_death,
            jax.random.uniform(k_bd, (ntemps, nwalkers)) < 0.5,
            can_birth,
        )
        u_slot = jax.random.uniform(k_slot, (ntemps, nwalkers, nlmax))
        score_birth = jnp.where(inds, -jnp.inf, u_slot)
        score_death = jnp.where(inds, u_slot, -jnp.inf)
        slot = jnp.where(
            do_birth,
            jnp.argmax(score_birth, axis=-1),
            jnp.argmax(score_death, axis=-1),
        )
        onehot = jax.nn.one_hot(slot, nlmax, dtype=bool)

        # ---- reduced state (leaf in question removed) ----
        inds_red = jnp.where(do_birth[..., None], inds, inds & ~onehot)
        ll_red = logl_fn(coords, inds_red)
        ll_red = jnp.where(jnp.isnan(ll_red), -1e300, ll_red)
        lp_red = logp_fn(coords, inds_red)

        # ---- candidate cloud ----
        cand = self._draw(dist, k_draw, (ntemps, nwalkers, jtry, ndim))
        # death walkers: the real (to-be-removed) leaf occupies try 0
        cur_leaf = jnp.take_along_axis(
            coords, slot[..., None, None], axis=2
        )  # (T, W, 1, D)
        is_fill = (~do_birth)[..., None, None] & (
            jnp.arange(jtry)[None, None, :, None] == 0
        )
        cand = jnp.where(is_fill, cur_leaf, cand)
        logq = dist.logpdf(cand)  # (T, W, J)

        # ---- evaluate the cloud: fold J into the walker axis ----
        inds_new = inds_red | onehot[..., :]
        coords_j = jnp.broadcast_to(
            coords[:, :, None], (ntemps, nwalkers, jtry, nlmax, ndim)
        )
        put = onehot[:, :, None, :, None] & jnp.ones((1, 1, jtry, 1, 1), bool)
        coords_j = jnp.where(put, cand[:, :, :, None, :], coords_j)
        inds_j = jnp.broadcast_to(
            inds_new[:, :, None], (ntemps, nwalkers, jtry, nlmax)
        )
        ll_j = logl_fn(
            coords_j.reshape(ntemps, nwalkers * jtry, nlmax, ndim),
            inds_j.reshape(ntemps, nwalkers * jtry, nlmax),
        ).reshape(ntemps, nwalkers, jtry)
        lp_j = logp_fn(
            coords_j.reshape(ntemps, nwalkers * jtry, nlmax, ndim),
            inds_j.reshape(ntemps, nwalkers * jtry, nlmax),
        ).reshape(ntemps, nwalkers, jtry)
        ll_j = jnp.where(jnp.isnan(ll_j), -1e300, ll_j)
        ll_j = jnp.where(jnp.isfinite(lp_j), ll_j, -1e300)

        logw = betas[:, None, None] * ll_j + lp_j - logq - lp_red[..., None]
        logw = jnp.where(jnp.isfinite(logw), logw, -jnp.inf)

        # ---- selection: Gumbel-max for birth, forced try 0 for death ----
        # (subclasses may set _greedy_select for argmax search mode,
        # see moves.gb.BruteRejectionRJ take_max_ll)
        g = -jnp.log(-jnp.log(jax.random.uniform(k_sel, logw.shape)))
        if getattr(self, "_greedy_select", False):
            g = jnp.zeros_like(g)
        sel = jnp.where(do_birth, jnp.argmax(logw + g, axis=-1), 0)

        take = lambda arr: jnp.take_along_axis(arr, sel[..., None], axis=-1)[..., 0]
        y = jnp.take_along_axis(cand, sel[..., None, None], axis=2)[..., 0, :]
        ll_sel, lp_sel = take(ll_j), take(lp_j)

        # ---- I-MTM estimator + slot combinatorics ----
        core = (
            jax.nn.logsumexp(logw, axis=-1)
            - betas[:, None] * ll_red
            - math.log(jtry)
        )
        n_inactive = nlmax - n_active
        comb_birth = jnp.log(jnp.maximum(n_inactive, 1)) - jnp.log(n_active + 1.0)
        comb_death = jnp.log(jnp.maximum(n_active, 1)) - jnp.log(n_inactive + 1.0)
        lnpdiff = jnp.where(do_birth, comb_birth + core, comb_death - core)

        accept = jnp.log(jax.random.uniform(k_u, (ntemps, nwalkers))) < lnpdiff
        legal = jnp.where(do_birth, can_birth, can_death)
        accept = accept & legal & jnp.where(do_birth, jnp.isfinite(lp_sel), True)

        # ---- apply: birth installs the chosen candidate; death removes ----
        acc_birth = accept & do_birth
        acc_death = accept & ~do_birth
        coords = jnp.where(
            (acc_birth[..., None] & onehot)[..., None], y[..., None, :], coords
        )
        inds = jnp.where(
            acc_birth[..., None], inds | onehot,
            jnp.where(acc_death[..., None], inds & ~onehot, inds),
        )
        log_like = jnp.where(
            acc_birth, ll_sel, jnp.where(acc_death, ll_red, log_like)
        )
        log_prior = jnp.where(
            acc_birth, lp_sel, jnp.where(acc_death, lp_red, log_prior)
        )
        return coords, inds, log_like, log_prior, jnp.sum(accept, axis=1).astype(jnp.int32)


__all__ = ["MTDistGenMove", "MTDistGenMoveRJ"]
