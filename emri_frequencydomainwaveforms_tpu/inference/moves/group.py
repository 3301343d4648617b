"""Group moves, delayed rejection, and move composition (jittable).

Rebuilds the remaining members of Eryn's move family:

* ``GroupStretchMove`` (reference ``Eryn/eryn/moves/groupstretch.py:15`` /
  ``group.py:14``): a stretch proposal whose complement ensemble is a
  FROZEN "friends" snapshot rather than the live other half — the
  stationary-complement trick that keeps proposals well-shaped when the
  live ensemble is degenerate (e.g. during search). The friends snapshot
  is closed over as a device array; call ``set_friends`` (host-side, e.g.
  from an ``update_fn``) to refresh it. Because the complement
  distribution is fixed, the proposal is an independence-flavored affine
  move and the Goodman-Weare factor ``(ndim-1) log z`` applies unchanged.
* ``DelayedRejectionMove`` (reference ``moves/delayedrejection.py:31``): a
  two-stage symmetric random-walk MH — on first-stage rejection, retry
  with a ``scale_2``-shrunk step and accept with the Tierney-Mira DR
  ratio. Both stages evaluate in the same jitted call (no
  data-dependent control flow; the second stage's work is masked out for
  walkers that accepted stage one).
* ``CombineMove`` (reference ``moves/combine.py:11``): apply a sequence of
  moves in order within one proposal call.

All three implement the flat move contract
``propose(key, coords, log_like, log_prior, betas, logp_fn, logl_fn)``.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from .stretch import StretchMove


class GroupStretchMove(StretchMove):
    """Stretch move against a frozen friends ensemble."""

    def __init__(self, friends=None, n_friends: int | None = None, **kwargs):
        super().__init__(**kwargs)
        self.friends = None if friends is None else jnp.asarray(friends)
        self.n_friends = n_friends

    def set_friends(self, friends):
        """Install a new stationary complement (e.g. current best walkers)."""
        self.friends = jnp.asarray(friends)

    def find_friends(self, coords):
        """Default friends selection: the current coords snapshot."""
        self.set_friends(coords)

    def propose(self, key, coords, log_like, log_prior, betas, logp_fn, logl_fn):
        if self.friends is None:
            # fall back to the live-ensemble stretch until friends are set
            return super().propose(
                key, coords, log_like, log_prior, betas, logp_fn, logl_fn
            )
        ntemps, nwalkers, ndim = coords.shape
        friends = self.friends
        if friends.ndim == 2:  # (n_friends, ndim) shared across temps
            friends = jnp.broadcast_to(
                friends[None], (ntemps,) + friends.shape
            )
        nf = friends.shape[1]
        a = self.a

        key, k_z, k_c, k_u = jax.random.split(key, 4)
        z = ((a - 1.0) * jax.random.uniform(k_z, (ntemps, nwalkers)) + 1.0) ** 2 / a
        pick = jax.random.randint(k_c, (ntemps, nwalkers), 0, nf)
        c_pick = jnp.take_along_axis(friends, pick[..., None], axis=1)

        diff = self._diff(coords, c_pick, self.periodic)
        prop = self._wrap(c_pick + z[..., None] * diff, self.periodic)

        lp_new = logp_fn(prop.reshape(-1, ndim)).reshape(ntemps, nwalkers)
        ll_new = logl_fn(prop.reshape(-1, ndim)).reshape(ntemps, nwalkers)
        ll_new = jnp.where(jnp.isnan(ll_new), -1e300, ll_new)
        ll_new = jnp.where(jnp.isfinite(lp_new), ll_new, -1e300)

        factors = (ndim - 1.0) * jnp.log(z)
        lnpdiff = factors + betas[:, None] * (ll_new - log_like) + (lp_new - log_prior)
        accept = jnp.log(jax.random.uniform(k_u, (ntemps, nwalkers))) < lnpdiff
        accept = accept & jnp.isfinite(lp_new)

        coords = jnp.where(accept[..., None], prop, coords)
        log_like = jnp.where(accept, ll_new, log_like)
        log_prior = jnp.where(accept, lp_new, log_prior)
        return coords, log_like, log_prior, jnp.sum(accept, axis=1).astype(jnp.int32)


class DelayedRejectionMove:
    """Two-stage delayed-rejection Gaussian random walk.

    Stage 1: step ~ N(0, sigma^2); stage 2 (on rejection): step ~
    N(0, (scale_2 sigma)^2) accepted with the DR ratio

      alpha_2 = min(1, [pi(y2) (1 - alpha_1(y2 -> y1))]
                       / [pi(x) (1 - alpha_1(x -> y1))])

    (symmetric proposals cancel). ``sigma``: scalar or (ndim,).
    """

    def __init__(self, sigma, scale_2: float = 0.25, periodic=None, **kwargs):
        del kwargs
        self.sigma = jnp.asarray(sigma)
        self.scale_2 = scale_2
        self.periodic = periodic

    def _wrap(self, x):
        if self.periodic is None:
            return x
        per = jnp.asarray(self.periodic)
        return jnp.where(per > 0, jnp.mod(x, jnp.where(per > 0, per, 1.0)), x)

    def propose(self, key, coords, log_like, log_prior, betas, logp_fn, logl_fn):
        ntemps, nwalkers, ndim = coords.shape
        key, k1, k2, ku1, ku2 = jax.random.split(key, 5)

        def post(x):
            lp = logp_fn(x.reshape(-1, ndim)).reshape(ntemps, nwalkers)
            ll = logl_fn(x.reshape(-1, ndim)).reshape(ntemps, nwalkers)
            ll = jnp.where(jnp.isnan(ll), -1e300, ll)
            ll = jnp.where(jnp.isfinite(lp), ll, -1e300)
            return ll, lp

        y1 = self._wrap(coords + jax.random.normal(k1, coords.shape) * self.sigma)
        ll1, lp1 = post(y1)
        lnp_x = betas[:, None] * log_like + log_prior
        lnp_1 = betas[:, None] * ll1 + lp1
        log_a1 = jnp.minimum(lnp_1 - lnp_x, 0.0)
        acc1 = jnp.log(jax.random.uniform(ku1, (ntemps, nwalkers))) < log_a1
        acc1 = acc1 & jnp.isfinite(lp1)

        # stage 2 from the ORIGINAL point with a shrunk step
        y2 = self._wrap(
            coords + jax.random.normal(k2, coords.shape) * (self.scale_2 * self.sigma)
        )
        ll2, lp2 = post(y2)
        lnp_2 = betas[:, None] * ll2 + lp2
        # alpha_1 of the reverse path y2 -> y1
        log_a1_rev = jnp.minimum(lnp_1 - lnp_2, 0.0)
        log1m = lambda la: jnp.log1p(-jnp.minimum(jnp.exp(la), 1.0 - 1e-15))
        log_a2 = jnp.minimum(lnp_2 + log1m(log_a1_rev) - lnp_x - log1m(log_a1), 0.0)
        acc2 = jnp.log(jax.random.uniform(ku2, (ntemps, nwalkers))) < log_a2
        acc2 = acc2 & jnp.isfinite(lp2) & (~acc1)

        coords = jnp.where(
            acc1[..., None], y1, jnp.where(acc2[..., None], y2, coords)
        )
        log_like = jnp.where(acc1, ll1, jnp.where(acc2, ll2, log_like))
        log_prior = jnp.where(acc1, lp1, jnp.where(acc2, lp2, log_prior))
        n_acc = jnp.sum(acc1 | acc2, axis=1).astype(jnp.int32)
        return coords, log_like, log_prior, n_acc


class CombineMove:
    """Apply several flat-contract moves in sequence (reference ``:11``)."""

    def __init__(self, moves):
        self.moves = list(moves)
        self.periodic = None

    def propose(self, key, coords, log_like, log_prior, betas, logp_fn, logl_fn):
        n_acc = None
        for m in self.moves:
            key, k = jax.random.split(key)
            coords, log_like, log_prior, acc = m.propose(
                k, coords, log_like, log_prior, betas, logp_fn, logl_fn
            )
            n_acc = acc if n_acc is None else n_acc + acc
        return coords, log_like, log_prior, n_acc


__all__ = ["GroupStretchMove", "DelayedRejectionMove", "CombineMove"]
