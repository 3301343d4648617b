"""Sampler state tree (pytrees, jit-friendly).

Rebuilds Eryn's state containers (reference ``Eryn/eryn/state.py``:
``Branch``:332 with coords ``(ntemps, nwalkers, nleaves_max, ndim)`` + bool
``inds``; ``State``:390 = branches + log_like + log_prior + betas + blobs +
random_state; ``BranchSupplimental``:16 side-car data;
``get_log_posterior(temper)``:541).

The State is a registered pytree so a whole MCMC iteration — moves, accept
logic, temperature swaps — jit-compiles over it; the ``random_state`` slot
holds a jax PRNG key (the jittable replacement for the numpy RandomState
the reference persists).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Branch(NamedTuple):
    """One model family's walker coordinates.

    coords: (ntemps, nwalkers, nleaves_max, ndim); inds: boolean leaf
    activation (ntemps, nwalkers, nleaves_max) for reversible-jump.
    """

    coords: jax.Array
    inds: jax.Array

    @property
    def shape(self):
        return self.coords.shape

    @property
    def nleaves(self):
        return jnp.sum(self.inds, axis=-1)


class State(NamedTuple):
    """Full sampler state: branches + cached posteriors + tempering + PRNG."""

    branches: dict[str, Branch]
    log_like: jax.Array  # (ntemps, nwalkers)
    log_prior: jax.Array
    betas: jax.Array  # (ntemps,)
    random_state: jax.Array  # jax PRNG key
    blobs: Any = None
    # carried per-move adaptation state (tuple aligned with sampler.moves;
    # None slots for stateless moves) — e.g. DIMEMove's exponential-memory
    # proposal moments ride the State pytree through the jitted step the way
    # the reference keeps them as move-object attributes (stretch.py:287-289)
    move_info: Any = None

    @property
    def branches_coords(self):
        return {k: b.coords for k, b in self.branches.items()}

    @property
    def branches_inds(self):
        return {k: b.inds for k, b in self.branches.items()}

    def get_log_posterior(self, temper: bool = False):
        if temper:
            return self.betas[:, None] * self.log_like + self.log_prior
        return self.log_like + self.log_prior


def make_state(
    coords,
    log_like=None,
    log_prior=None,
    betas=None,
    inds=None,
    random_state=None,
    blobs=None,
    name: str = "model_0",
) -> State:
    """Build a State from raw arrays (reference ``State.__init__`` parity).

    ``coords`` may be an array ``(ntemps, nwalkers, nleaves_max, ndim)`` or a
    dict of such arrays per branch.
    """
    if not isinstance(coords, dict):
        coords = {name: coords}
    branches = {}
    for k, c in coords.items():
        c = jnp.asarray(c)
        if c.ndim == 3:
            c = c[:, :, None, :]
        if inds is not None and isinstance(inds, dict) and k in inds:
            b_inds = jnp.asarray(inds[k])
        else:
            b_inds = jnp.ones(c.shape[:-1], bool)
        branches[k] = Branch(coords=c, inds=b_inds)
    first = next(iter(branches.values()))
    ntemps, nwalkers = first.coords.shape[:2]
    if log_like is None:
        log_like = jnp.zeros((ntemps, nwalkers))
    if log_prior is None:
        log_prior = jnp.zeros((ntemps, nwalkers))
    if betas is None:
        betas = jnp.ones((ntemps,))
    if random_state is None:
        random_state = jax.random.PRNGKey(0)
    return State(
        branches=branches,
        log_like=jnp.asarray(log_like),
        log_prior=jnp.asarray(log_prior),
        betas=jnp.asarray(betas),
        random_state=random_state,
        blobs=blobs,
    )


class BranchSupplimental:
    """Host-side object side-car keyed like a branch (reference ``:16``).

    Holds arbitrary per-leaf numpy/object data that travels with walker
    reshuffles via take/put-along-axis on the host (not traced)."""

    def __init__(self, obj_info: dict, base_shape=None):
        self.holder = {k: np.asarray(v) for k, v in obj_info.items()}
        self.base_shape = base_shape

    def __getitem__(self, key):
        return self.holder[key]

    def take_along_axis(self, indices, axis: int):
        return {
            k: np.take_along_axis(v, indices.reshape(indices.shape + (1,) * (v.ndim - indices.ndim)), axis=axis)
            for k, v in self.holder.items()
        }

    def put_along_axis(self, indices, values: dict, axis: int):
        for k, v in values.items():
            np.put_along_axis(
                self.holder[k],
                indices.reshape(indices.shape + (1,) * (self.holder[k].ndim - indices.ndim)),
                v,
                axis=axis,
            )


__all__ = ["Branch", "State", "make_state", "BranchSupplimental"]
