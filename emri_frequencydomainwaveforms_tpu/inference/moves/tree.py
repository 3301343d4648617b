"""Multi-branch (tree) in-model moves over dict-of-branches states.

Rebuilds the multi-leaf / multi-branch proposal layer of Eryn's move stack
(reference ``Eryn/eryn/moves/move.py:16`` Gibbs-setup machinery,
``moves/stretch.py:14`` per-leaf stretch, ``moves/gaussian.py:42`` leaf
perturbations) as TREE moves: one proposal updates every branch's ACTIVE
leaves in a single batched evaluation.

Contract (the tree analogue of the flat move contract):

  propose(key, coords: dict[str, (T, W, L_b, d_b)], inds: dict[str,
  (T, W, L_b) bool], log_like, log_prior, betas, logp_fn, logl_fn)
    -> (coords, inds, log_like, log_prior, n_accepted)

with ``logp_fn(coords, inds) -> (T, W)`` (active-leaf prior sum) and
``logl_fn(coords, inds) -> (T, W)``.

Design deviation from the reference (documented): Eryn Gibbs-iterates
branches and leaves with per-leaf proposals driven by host loops; here one
walker-level proposal moves ALL branches' active leaves at once — for the
stretch move a single affine factor z per walker applies across branches,
with the Goodman-Weare Jacobian exponent counting the walker's actually
moved dimensions (slots active in both the walker and its complement
partner). This is a valid affine-invariant proposal on the product space
and compiles to one XLA program with no host loops (the jitted
equivalent of vectorize=True). Random-scan Gibbs over branches is
available via ``gibbs_branches``.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


def _tree_shapes(coords: dict):
    first = next(iter(coords.values()))
    return first.shape[0], first.shape[1]  # ntemps, nwalkers


class TreeStretchMove:
    """Affine-invariant stretch over every branch's active leaves."""

    def __init__(self, a: float = 2.0, periodic: dict | None = None,
                 gibbs_branches: list | None = None, **kwargs):
        del kwargs
        self.a = a
        self.periodic = periodic or {}
        # optional random-scan Gibbs: list of branch-name tuples; each call
        # updates one tuple drawn uniformly (None = all branches each call)
        self.gibbs_branches = gibbs_branches

    def _diff(self, name, x1, x2):
        d = x1 - x2
        per = self.periodic.get(name)
        if per is None:
            return d
        per = jnp.asarray(per)
        wrapped = d - per * jnp.round(d / jnp.where(per > 0, per, 1.0))
        return jnp.where(per > 0, wrapped, d)

    def _wrap(self, name, x):
        per = self.periodic.get(name)
        if per is None:
            return x
        per = jnp.asarray(per)
        return jnp.where(per > 0, jnp.mod(x, jnp.where(per > 0, per, 1.0)), x)

    def propose(self, key, coords, inds, log_like, log_prior, betas,
                logp_fn: Callable, logl_fn: Callable):
        ntemps, nwalkers = _tree_shapes(coords)
        nh = nwalkers // 2
        a = self.a
        names = list(coords.keys())

        if self.gibbs_branches is not None:
            key, k_g = jax.random.split(key)
            g_idx = jax.random.randint(k_g, (), 0, len(self.gibbs_branches))
            active_branch = {
                name: jnp.any(
                    jnp.asarray([name in grp for grp in self.gibbs_branches])
                    & (jnp.arange(len(self.gibbs_branches)) == g_idx)
                )
                for name in names
            }
        else:
            active_branch = {name: jnp.asarray(True) for name in names}

        def update_half(carry, half_idx):
            coords, log_like, log_prior, key, n_acc = carry
            key, k_z, k_c, k_u = jax.random.split(key, 4)

            z = ((a - 1.0) * jax.random.uniform(k_z, (ntemps, nh)) + 1.0) ** 2 / a
            partner = jax.random.randint(k_c, (ntemps, nh), 0, nh)

            prop = {}
            d_moved = jnp.zeros((ntemps, nh))
            for name in names:
                c = coords[name]
                ind = inds[name]
                d_b = c.shape[-1]
                s = jax.lax.dynamic_slice_in_dim(c, half_idx * nh, nh, axis=1)
                comp = jax.lax.dynamic_slice_in_dim(c, (1 - half_idx) * nh, nh, axis=1)
                ind_s = jax.lax.dynamic_slice_in_dim(ind, half_idx * nh, nh, axis=1)
                ind_c = jax.lax.dynamic_slice_in_dim(ind, (1 - half_idx) * nh, nh, axis=1)
                c_pick = jnp.take_along_axis(comp, partner[..., None, None], axis=1)
                ic_pick = jnp.take_along_axis(ind_c, partner[..., None], axis=1)

                move_mask = ind_s & ic_pick & active_branch[name][None, None, None]
                diff = self._diff(name, s, c_pick)
                moved = self._wrap(name, c_pick + z[..., None, None] * diff)
                prop[name] = jnp.where(move_mask[..., None], moved, s)
                d_moved = d_moved + jnp.sum(move_mask, axis=-1) * d_b

            # evaluate on the full walker set with the proposed half patched
            full = {
                name: jax.lax.dynamic_update_slice_in_dim(
                    coords[name], prop[name], half_idx * nh, axis=1
                )
                for name in names
            }
            lp_full = logp_fn(full, inds)
            ll_full = logl_fn(full, inds)
            lp_new = jax.lax.dynamic_slice_in_dim(lp_full, half_idx * nh, nh, axis=1)
            ll_new = jax.lax.dynamic_slice_in_dim(ll_full, half_idx * nh, nh, axis=1)
            ll_new = jnp.where(jnp.isnan(ll_new), -1e300, ll_new)
            ll_new = jnp.where(jnp.isfinite(lp_new), ll_new, -1e300)
            ll_s = jax.lax.dynamic_slice_in_dim(log_like, half_idx * nh, nh, axis=1)
            lp_s = jax.lax.dynamic_slice_in_dim(log_prior, half_idx * nh, nh, axis=1)

            factors = jnp.where(d_moved > 0, (d_moved - 1.0) * jnp.log(z), 0.0)
            lnpdiff = factors + betas[:, None] * (ll_new - ll_s) + (lp_new - lp_s)
            accept = jnp.log(jax.random.uniform(k_u, (ntemps, nh))) < lnpdiff
            accept = accept & jnp.isfinite(lp_new) & (d_moved > 0)

            for name in names:
                s = jax.lax.dynamic_slice_in_dim(coords[name], half_idx * nh, nh, axis=1)
                new_s = jnp.where(accept[..., None, None], prop[name], s)
                coords[name] = jax.lax.dynamic_update_slice_in_dim(
                    coords[name], new_s, half_idx * nh, axis=1
                )
            log_like = jax.lax.dynamic_update_slice_in_dim(
                log_like, jnp.where(accept, ll_new, ll_s), half_idx * nh, axis=1
            )
            log_prior = jax.lax.dynamic_update_slice_in_dim(
                log_prior, jnp.where(accept, lp_new, lp_s), half_idx * nh, axis=1
            )
            n_acc = n_acc + jnp.sum(accept, axis=1).astype(jnp.int32)
            return (coords, log_like, log_prior, key, n_acc), None

        carry = (dict(coords), log_like, log_prior, key, jnp.zeros((ntemps,), jnp.int32))
        for half in (0, 1):  # python loop: dict carries stay pytrees of fixed structure
            carry, _ = update_half(carry, half)
        coords, log_like, log_prior, _, n_acc = carry
        return coords, dict(inds), log_like, log_prior, n_acc


class TreeGaussianMove:
    """Gaussian random-walk MH over every branch's active leaves.

    ``cov``: dict branch -> scalar | (d,) diagonal | (d, d) full covariance
    (reference ``GaussianMove`` modes; full covariance is Cholesky-applied).
    """

    def __init__(self, cov: dict, periodic: dict | None = None,
                 gibbs_branches: list | None = None, **kwargs):
        del kwargs
        self.periodic = periodic or {}
        self.gibbs_branches = gibbs_branches
        self._chol = {}
        for name, c in cov.items():
            c = np.asarray(c, dtype=np.float64)
            if c.ndim == 2:
                self._chol[name] = ("full", jnp.asarray(np.linalg.cholesky(c)))
            else:
                self._chol[name] = ("diag", jnp.asarray(np.sqrt(c)))

    def _wrap(self, name, x):
        per = self.periodic.get(name)
        if per is None:
            return x
        per = jnp.asarray(per)
        return jnp.where(per > 0, jnp.mod(x, jnp.where(per > 0, per, 1.0)), x)

    def propose(self, key, coords, inds, log_like, log_prior, betas,
                logp_fn: Callable, logl_fn: Callable):
        ntemps, nwalkers = _tree_shapes(coords)
        names = list(coords.keys())
        key, k_u, k_g = jax.random.split(key, 3)

        if self.gibbs_branches is not None:
            g_idx = jax.random.randint(k_g, (), 0, len(self.gibbs_branches))
            branch_on = {
                name: jnp.any(
                    jnp.asarray([name in grp for grp in self.gibbs_branches])
                    & (jnp.arange(len(self.gibbs_branches)) == g_idx)
                )
                for name in names
            }
        else:
            branch_on = {name: jnp.asarray(True) for name in names}

        prop = {}
        for name in names:
            key, k_n = jax.random.split(key)
            c = coords[name]
            kind, fac = self._chol[name]
            eps = jax.random.normal(k_n, c.shape)
            step = eps @ fac.T if kind == "full" else eps * fac
            mask = (inds[name] & branch_on[name][None, None, None])[..., None]
            prop[name] = self._wrap(name, jnp.where(mask, c + step, c))

        lp_new = logp_fn(prop, inds)
        ll_new = logl_fn(prop, inds)
        ll_new = jnp.where(jnp.isnan(ll_new), -1e300, ll_new)
        ll_new = jnp.where(jnp.isfinite(lp_new), ll_new, -1e300)

        lnpdiff = betas[:, None] * (ll_new - log_like) + (lp_new - log_prior)
        accept = (jnp.log(jax.random.uniform(k_u, (ntemps, nwalkers))) < lnpdiff)
        accept = accept & jnp.isfinite(lp_new)

        coords = {
            name: jnp.where(accept[..., None, None], prop[name], coords[name])
            for name in names
        }
        log_like = jnp.where(accept, ll_new, log_like)
        log_prior = jnp.where(accept, lp_new, log_prior)
        return coords, dict(inds), log_like, log_prior, jnp.sum(accept, axis=1).astype(jnp.int32)


__all__ = ["TreeStretchMove", "TreeGaussianMove"]
