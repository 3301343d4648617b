"""Tempered ensemble sampler (jit-stepped), single- and multi-branch.

Rebuilds Eryn's ``EnsembleSampler`` orchestration (reference
``Eryn/eryn/ensemble.py:31``: branch/ndim bookkeeping :256-309,
TemperatureControl setup :311-324, move schedule :341-474, backend
init/resume :520-571, ``sample`` generator :734-945 with separate in-model
and RJ proposal phases :879-916, ``run_mcmc`` with burn + stopping/update
hooks :947-1037, ``compute_log_prior``:1046 / ``compute_log_like``:1133
with -inf-prior masking and NaN->-1e300 fill :1397-1424).

Two configurations share one driver:

* **single-branch fixed-dimension** (the ``emri_pe.py`` path): coords
  ``(ntemps, nwalkers, ndim)``, flat-contract moves (StretchMove,
  GaussianMove, MTDistGenMove, GroupStretchMove, ...), likelihood over a
  ``(n, ndim)`` batch;
* **multi-branch / reversible-jump** (``nleaves_max > 1``, multiple
  ``branch_names``, or ``rj_moves``): coords/inds dicts per branch, tree
  moves (TreeStretchMove, TreeGaussianMove) for the in-model phase and
  ``DistributionGenerateRJ.propose_tree`` for trans-dimensional birth /
  death. The likelihood contract here is ``log_like_fn(coords,
  inds, *args) -> (ntemps, nwalkers)`` with masked leaves (dicts for
  multiple branches, bare arrays for one branch) — the jit-compilable
  replacement for the reference's per-leaf host loops.

Structure: one full iteration — in-model move (weighted
`lax.switch` schedule), RJ moves, temperature swap cascade, ladder
adaptation — is a single pure jitted function of the state pytree; the
Python loop only pumps iterations and streams thinned samples to the
backend.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .backends.memory import Backend
from .moves.gaussian import GaussianMove
from .moves.rj import DistributionGenerateRJ
from .moves.stretch import StretchMove
from .moves.tempering import TemperatureControl
from .moves.tree import TreeGaussianMove, TreeStretchMove
from .prior import ProbDistContainer
from .state import Branch, State, make_state


def _as_branch_dict(value, branch_names, default):
    if isinstance(value, dict):
        return {k: value.get(k, default) for k in branch_names}
    return {k: value for k in branch_names}


class EnsembleSampler:
    """Parallel-tempered ensemble MCMC (fixed-dim or reversible-jump)."""

    def __init__(
        self,
        nwalkers: int,
        ndims,
        log_like_fn: Callable,
        priors,
        *,
        tempering_kwargs=None,
        moves=None,
        rj_moves=None,
        args=None,
        kwargs=None,
        backend=None,
        vectorize: bool = True,
        periodic=None,
        update_fn=None,
        update_iterations: int = -1,
        stopping_fn=None,
        stopping_iterations: int = -1,
        branch_names=None,
        nbranches: int = 1,
        nleaves_max=1,
        nleaves_min=0,
        info=None,
        seed: int = 0,
        **extra,
    ):
        del vectorize, nbranches, extra
        self.nwalkers = nwalkers

        # ---- branch bookkeeping ----
        if isinstance(ndims, dict):
            branch_names = branch_names or list(ndims)
            self.ndims = {k: int(v) for k, v in ndims.items()}
        elif isinstance(ndims, (list, tuple, np.ndarray)):
            branch_names = branch_names or [f"model_{i}" for i in range(len(ndims))]
            self.ndims = {k: int(d) for k, d in zip(branch_names, ndims)}
        else:
            branch_names = branch_names or ["model_0"]
            self.ndims = {branch_names[0]: int(ndims)}
        self.branch_names = list(branch_names)
        self.branch_name = self.branch_names[0]
        self.ndim = self.ndims[self.branch_name]
        self.nleaves_max = _as_branch_dict(nleaves_max, self.branch_names, 1)
        self.nleaves_min = _as_branch_dict(nleaves_min, self.branch_names, 0)

        self.log_like_fn = log_like_fn
        self.args = tuple(args or ())
        self.kwargs = dict(kwargs or {})

        # ---- priors ----
        self.priors = self._parse_priors(priors)
        self._prior = self.priors[self.branch_name]

        # ---- rj configuration ----
        if rj_moves is True:
            rj_moves = [
                DistributionGenerateRJ(
                    self.priors, nleaves_min=self.nleaves_min,
                    nleaves_max=self.nleaves_max,
                )
            ]
        elif rj_moves in (None, False):
            rj_moves = []
        elif not isinstance(rj_moves, (list, tuple)):
            rj_moves = [rj_moves]
        self.rj_moves = list(rj_moves)
        self.has_reversible_jump = bool(self.rj_moves)
        self.multibranch = (
            len(self.branch_names) > 1
            or any(v > 1 for v in self.nleaves_max.values())
            or self.has_reversible_jump
        )

        tempering_kwargs = dict(tempering_kwargs or {})
        ntemps = tempering_kwargs.pop("ntemps", 1)
        ndim_total = sum(
            self.ndims[k] * self.nleaves_max[k] for k in self.branch_names
        )
        self.temperature_control = TemperatureControl(
            ndim_total, nwalkers, ntemps=ntemps, **tempering_kwargs
        )
        self.ntemps = self.temperature_control.ntemps

        per_vec = None
        if periodic is not None and not self.multibranch:
            per = periodic.get(self.branch_name, periodic) if isinstance(periodic, dict) else periodic
            vec = np.zeros(self.ndim)
            for idx, p in per.items():
                vec[int(idx)] = p
            per_vec = jnp.asarray(vec)
        self.periodic_vec = per_vec

        # ---- move schedule ----
        if moves is None:
            moves = (
                TreeStretchMove() if self.multibranch
                else StretchMove(periodic=per_vec)
            )
        if isinstance(moves, (list, tuple)):
            pairs = [m if isinstance(m, tuple) else (m, 1.0) for m in moves]
            self.moves = [self._adapt_move(m) for m, _ in pairs]
            w = np.array([float(wt) for _, wt in pairs])
            self.move_weights = w / w.sum()
        else:
            self.moves = [self._adapt_move(moves)]
            self.move_weights = np.array([1.0])
        if not self.multibranch:
            for m in self.moves:
                if getattr(m, "periodic", None) is None:
                    m.periodic = per_vec
        self.move = self.moves[0]

        self.backend = backend if backend is not None else Backend()
        if isinstance(self.backend, str):
            from .backends.hdf import HDFBackend

            self.backend = HDFBackend(self.backend)
        if not self.backend.initialized:
            self.backend.reset(
                nwalkers,
                self.ndims,
                ntemps=self.ntemps,
                nleaves_max=self.nleaves_max,
                branch_names=self.branch_names,
            )
        if info:
            self.backend.info.update(info)

        self.update_fn = update_fn
        self.update_iterations = update_iterations
        self.stopping_fn = stopping_fn
        self.stopping_iterations = stopping_iterations
        self._key = jax.random.PRNGKey(seed)
        self._step_jit = jax.jit(self._step)
        self._step_tree_jit = jax.jit(self._step_tree)

    def _parse_priors(self, priors):
        if isinstance(priors, ProbDistContainer):
            return {self.branch_name: priors}
        if isinstance(priors, dict):
            if all(isinstance(k, str) for k in priors):
                out = {}
                for k, v in priors.items():
                    out[k] = v if isinstance(v, ProbDistContainer) else ProbDistContainer(v)
                return out
            return {self.branch_name: ProbDistContainer(priors)}
        raise ValueError("priors must be a dict or ProbDistContainer")

    def _adapt_move(self, move):
        """Lift flat moves into tree moves when running multi-branch."""
        if not self.multibranch:
            return move
        if hasattr(move, "propose_tree") or isinstance(
            move, (TreeStretchMove, TreeGaussianMove)
        ):
            return move
        if isinstance(move, GaussianMove) and getattr(move, "cov_dict", None) is not None:
            return TreeGaussianMove(move.cov_dict)
        if isinstance(move, GaussianMove) and move._chol is not None:
            return TreeGaussianMove(
                {k: np.asarray(move._chol @ move._chol.T) for k in self.branch_names}
            )
        if isinstance(move, GaussianMove) and move._scale is not None:
            return TreeGaussianMove(
                {
                    k: (move._scale**2) * np.ones(self.ndims[k])
                    for k in self.branch_names
                }
            )
        if isinstance(move, StretchMove):
            return TreeStretchMove(a=move.a)
        raise ValueError(
            f"move {type(move).__name__} has no multi-branch (tree) form"
        )

    # ---- model evaluation ----
    def _tree_logp(self, coords: dict, inds: dict):
        lp = 0.0
        for name, c in coords.items():
            leaf_lp = self.priors[name].logpdf(c)  # (..., L)
            lp = lp + jnp.sum(jnp.where(inds[name], leaf_lp, 0.0), axis=-1)
        return lp

    def _tree_logl(self, coords: dict, inds: dict):
        if len(self.branch_names) == 1:
            name = self.branch_names[0]
            ll = self.log_like_fn(coords[name], inds[name], *self.args, **self.kwargs)
        else:
            ll = self.log_like_fn(coords, inds, *self.args, **self.kwargs)
        ll = jnp.asarray(ll)
        return jnp.where(jnp.isnan(ll), -1e300, ll)

    def compute_log_prior(self, coords, inds=None):
        if isinstance(coords, dict):
            coords = {k: jnp.asarray(v) for k, v in coords.items()}
            if inds is None:
                inds = {k: jnp.ones(v.shape[:-1], bool) for k, v in coords.items()}
            else:
                inds = {k: jnp.asarray(v) for k, v in inds.items()}
            return self._tree_logp(coords, inds)
        return self._prior.logpdf(jnp.asarray(coords))

    def compute_log_like(self, coords, inds=None, logp=None):
        if isinstance(coords, dict):
            coords = {k: jnp.asarray(v) for k, v in coords.items()}
            if inds is None:
                inds = {k: jnp.ones(v.shape[:-1], bool) for k, v in coords.items()}
            else:
                inds = {k: jnp.asarray(v) for k, v in inds.items()}
            ll = self._tree_logl(coords, inds)
            if logp is not None:
                ll = jnp.where(jnp.isfinite(jnp.asarray(logp)), ll, -1e300)
            return ll, None
        coords = jnp.asarray(coords)
        flat = coords.reshape(-1, self.ndim)
        ll = self.log_like_fn(flat, *self.args, **self.kwargs)
        ll = jnp.asarray(ll).reshape(coords.shape[:-1])
        ll = jnp.where(jnp.isnan(ll), -1e300, ll)
        if logp is not None:
            ll = jnp.where(jnp.isfinite(jnp.asarray(logp)), ll, -1e300)
        return ll

    # ---- one jitted iteration (single-branch fixed-dim) ----
    def _step(self, coords, log_like, log_prior, betas, key, iteration, move_info):
        logp_fn = lambda x: self._prior.logpdf(x)

        def logl_fn(x):
            ll = self.log_like_fn(x, *self.args, **self.kwargs)
            return jnp.asarray(ll)

        def run_move(j, m, k, c, llv, lpv, minfo):
            # stateful moves (DIME) thread their adaptation state through
            # the move_info tuple slot aligned with the move index
            if hasattr(m, "propose_stateful") and minfo[j] is not None:
                c, llv, lpv, na, ms = m.propose_stateful(
                    k, c, llv, lpv, betas, logp_fn, logl_fn, minfo[j]
                )
                minfo = tuple(ms if jj == j else minfo[jj] for jj in range(len(minfo)))
            else:
                c, llv, lpv, na = m.propose(k, c, llv, lpv, betas, logp_fn, logl_fn)
            return c, llv, lpv, na, minfo

        key, k_move, k_sel, k_swap = jax.random.split(key, 4)
        if len(self.moves) == 1:
            coords, log_like, log_prior, n_acc, move_info = run_move(
                0, self.move, k_move, coords, log_like, log_prior, move_info
            )
        else:
            branches = [
                (
                    lambda args, j=j, m=m: run_move(
                        j, m, args[0], args[1], args[2], args[3], args[4]
                    )
                )
                for j, m in enumerate(self.moves)
            ]
            idx = jax.random.choice(
                k_sel, len(self.moves), p=jnp.asarray(self.move_weights)
            )
            coords, log_like, log_prior, n_acc, move_info = jax.lax.switch(
                idx, branches, (k_move, coords, log_like, log_prior, move_info)
            )
        tc = self.temperature_control
        if self.ntemps > 1:
            coords, log_like, log_prior, swap_frac = tc.temperature_swaps(
                k_swap, coords, log_like, log_prior, betas
            )
            betas = tc.adapt_ladder(betas, swap_frac, iteration.astype(jnp.float64))
        else:
            swap_frac = jnp.zeros((0,))
        return coords, log_like, log_prior, betas, key, n_acc, swap_frac, move_info

    # ---- one jitted iteration (multi-branch / RJ) ----
    def _step_tree(self, coords, inds, log_like, log_prior, betas, key, iteration):
        logp_fn = self._tree_logp
        logl_fn = self._tree_logl

        key, k_move, k_sel = jax.random.split(key, 3)
        if len(self.moves) == 1:
            coords, inds, log_like, log_prior, n_acc = self.move.propose(
                k_move, coords, inds, log_like, log_prior, betas, logp_fn, logl_fn
            )
        else:
            branches = [
                (
                    lambda a, m=m: m.propose(
                        a[0], a[1], a[2], a[3], a[4], betas, logp_fn, logl_fn
                    )
                )
                for m in self.moves
            ]
            idx = jax.random.choice(
                k_sel, len(self.moves), p=jnp.asarray(self.move_weights)
            )
            coords, inds, log_like, log_prior, n_acc = jax.lax.switch(
                idx, branches, (k_move, coords, inds, log_like, log_prior)
            )

        n_rj = jnp.zeros_like(n_acc)
        for rj in self.rj_moves:
            key, k_rj = jax.random.split(key)
            coords, inds, log_like, log_prior, acc = rj.propose_tree(
                k_rj, coords, inds, log_like, log_prior, betas, logp_fn, logl_fn
            )
            n_rj = n_rj + acc

        tc = self.temperature_control
        if self.ntemps > 1:
            key, k_swap = jax.random.split(key)
            tree = (coords, inds)
            tree, log_like, log_prior, swap_frac = tc.temperature_swaps_tree(
                k_swap, tree, log_like, log_prior, betas
            )
            coords, inds = tree
            betas = tc.adapt_ladder(betas, swap_frac, iteration.astype(jnp.float64))
        else:
            swap_frac = jnp.zeros((0,))
        return coords, inds, log_like, log_prior, betas, key, n_acc, n_rj, swap_frac

    # ---- public API ----
    def run_mcmc(
        self,
        initial_state,
        nsteps: int,
        burn: int = 0,
        thin_by: int = 1,
        progress: bool = False,
        **kwargs,
    ) -> State:
        state = self._coerce_state(initial_state)
        if burn:
            for state in self.sample(state, iterations=burn, thin_by=1, store=False):
                pass
        last = state
        for last in self.sample(state, iterations=nsteps, thin_by=thin_by, store=True,
                                progress=progress):
            pass
        return last

    def sample(self, initial_state, iterations: int, thin_by: int = 1, store: bool = True,
               progress: bool = False):
        state = self._coerce_state(initial_state)
        if self.multibranch:
            yield from self._sample_tree(state, iterations, thin_by, store)
            return
        coords = state.branches[self.branch_name].coords[:, :, 0, :]
        log_like = state.log_like
        log_prior = state.log_prior
        betas = state.betas
        key = state.random_state

        ntemps, nwalkers, ndim = coords.shape
        move_info = state.move_info
        if move_info is None:
            move_info = tuple(
                m.init_move_state(ntemps, nwalkers, ndim)
                if hasattr(m, "init_move_state")
                else None
                for m in self.moves
            )

        it0 = self.backend.iteration * thin_by
        for i in range(iterations):
            for _ in range(thin_by):
                (coords, log_like, log_prior, betas, key, n_acc, swap_frac,
                 move_info) = self._step_jit(
                    coords, log_like, log_prior, betas, key,
                    jnp.asarray(it0 + i, jnp.float64), move_info,
                )
            state = State(
                branches={
                    self.branch_name: state.branches[self.branch_name]._replace(
                        coords=coords[:, :, None, :]
                    )
                },
                log_like=log_like,
                log_prior=log_prior,
                betas=betas,
                random_state=key,
                move_info=move_info,
            )
            if store:
                self.backend.save_step(state, np.asarray(n_acc), swap_frac=np.asarray(swap_frac))
            stop = self._run_hooks(i, state)
            yield state
            if stop:
                return

    def _sample_tree(self, state: State, iterations: int, thin_by: int, store: bool):
        coords = {k: b.coords for k, b in state.branches.items()}
        inds = {k: b.inds for k, b in state.branches.items()}
        log_like = state.log_like
        log_prior = state.log_prior
        betas = state.betas
        key = state.random_state

        it0 = self.backend.iteration * thin_by
        for i in range(iterations):
            for _ in range(thin_by):
                (coords, inds, log_like, log_prior, betas, key,
                 n_acc, n_rj, swap_frac) = self._step_tree_jit(
                    coords, inds, log_like, log_prior, betas, key,
                    jnp.asarray(it0 + i, jnp.float64),
                )
            state = State(
                branches={
                    k: Branch(coords=coords[k], inds=inds[k]) for k in coords
                },
                log_like=log_like,
                log_prior=log_prior,
                betas=betas,
                random_state=key,
            )
            if store:
                self.backend.save_step(
                    state, np.asarray(n_acc), rj_accepted=np.asarray(n_rj),
                    swap_frac=np.asarray(swap_frac),
                )
            stop = self._run_hooks(i, state)
            yield state
            if stop:
                return

    def _run_hooks(self, i, state) -> bool:
        if (
            self.stopping_fn is not None
            and self.stopping_iterations > 0
            and (i + 1) % self.stopping_iterations == 0
        ):
            if self.stopping_fn(i, state, self):
                return True
        if (
            self.update_fn is not None
            and self.update_iterations > 0
            and (i + 1) % self.update_iterations == 0
        ):
            self.update_fn(i, state, self)
        return False

    def _coerce_state(self, s) -> State:
        if isinstance(s, State):
            st = s
        elif isinstance(s, dict) and not any(isinstance(v, (dict,)) for v in s.values()) and "coords" in s:
            st = make_state(**s, name=self.branch_name)
        elif isinstance(s, dict):
            st = make_state(s)
        else:
            st = make_state(jnp.asarray(s), name=self.branch_name)
        betas = st.betas
        if betas.shape[0] != self.ntemps or (
            self.ntemps > 1 and bool(jnp.all(betas == 1.0))
        ):
            # raw-array initial states carry placeholder unit betas; install
            # the temperature ladder
            betas = self.temperature_control.betas
        if self.multibranch:
            coords = {k: b.coords for k, b in st.branches.items()}
            inds = {k: b.inds for k, b in st.branches.items()}
            lp = self._tree_logp(coords, inds)
            ll = st.log_like
            if bool(jnp.all(ll == 0)):
                ll = self._tree_logl(coords, inds)
                ll = jnp.where(jnp.isfinite(lp), ll, -1e300)
        else:
            coords = st.branches[self.branch_name].coords[:, :, 0, :]
            lp = self.compute_log_prior(coords)
            ll = st.log_like
            if bool(jnp.all(ll == 0)):
                ll = self.compute_log_like(coords, logp=lp)
        return State(
            branches=st.branches,
            log_like=ll,
            log_prior=lp,
            betas=betas,
            random_state=st.random_state if st.random_state is not None else self._key,
        )

    # ---- accessors (reference parity) ----
    def get_chain(self, **kwargs):
        return self.backend.get_chain(**kwargs)

    def get_inds(self, **kwargs):
        return self.backend.get_inds(**kwargs)

    def get_nleaves(self, **kwargs):
        return self.backend.get_nleaves(**kwargs)

    def get_log_like(self, **kwargs):
        return self.backend.get_log_like(**kwargs)

    def get_autocorr_time(self, **kwargs):
        return self.backend.get_autocorr_time(**kwargs)

    @property
    def acceptance_fraction(self):
        return self.backend.acceptance_fraction

    def walkers_independent(self, coords=None) -> bool:
        """Condition-number guard (reference ``ensemble.py:1586``)."""
        if coords is None:
            last = self.backend.get_last_sample()
            coords = last.branches[self.branch_name].coords[0, :, 0, :]
        x = np.asarray(coords)
        x = x - x.mean(axis=0)
        sigma = x.std(axis=0)
        sigma[sigma == 0] = 1.0
        cond = np.linalg.cond((x / sigma).astype(np.float64))
        return cond < 1e8


__all__ = ["EnsembleSampler"]
