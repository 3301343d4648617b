"""Spin-weighted spherical harmonics (s = -2) in JAX.

Replaces the reference engine's ``few.utils.ylm.GetYlms`` (used at reference
``Tutorial_FD_construction_single_mode.ipynb`` cells 3, 5, 23, 26:
``ylm_gen(unique_l, unique_m, theta, phi)`` returning complex values, with
``assume_positive_m`` doubling to supply (l, -m) partners).

Implementation: Goldberg et al. (1967) closed form

  sY_lm = (-1)^m sqrt[(l+m)!(l-m)!(2l+1) / (4 pi (l+s)!(l-s)!)]
          * sum_r C(l-s, r) C(l+s, r+s-m) (-1)^{l-r-s}
                  cos(th/2)^{2r+s-m} sin(th/2)^{2l-2r-s+m}  * e^{i m phi}

The (l, m)-dependent coefficients and integer exponents are precomputed
host-side into dense padded tables, so the device side is a small
polynomial-in-(cos, sin) contraction — jittable, vmappable, and autodiffable
(the angles are sampled parameters, so Fisher-matrix derivatives flow
through here). Results are returned as (re, im) f64 pairs (ROADMAP
Design item 3).

Verified cases: -2Y_22 = sqrt(5/64pi)(1+cos th)^2 e^{2i phi},
-2Y_20 = sqrt(15/32pi) sin^2 th.
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


def _binom(n: int, k: int) -> float:
    if k < 0 or k > n:
        return 0.0
    return math.comb(n, k)


@lru_cache(maxsize=None)
def _ylm_terms(l: int, m: int, s: int = -2) -> tuple[tuple[float, int, int], ...]:
    """(coef, pow_cos, pow_sin) terms of sY_lm as polynomial in cos/sin(th/2)."""
    if l < abs(s) or abs(m) > l:
        return ((0.0, 0, 0),)
    pref = (-1.0) ** m * math.sqrt(
        math.factorial(l + m)
        * math.factorial(l - m)
        * (2 * l + 1)
        / (4.0 * math.pi * math.factorial(l + s) * math.factorial(l - s))
    )
    terms = []
    for r in range(0, l - s + 1):
        c1 = _binom(l - s, r)
        c2 = _binom(l + s, r + s - m)
        if c1 == 0.0 or c2 == 0.0:
            continue
        sign = (-1.0) ** (l - r - s)
        pc = 2 * r + s - m
        ps = 2 * l - 2 * r - s + m
        if pc < 0 or ps < 0:
            continue
        terms.append((pref * c1 * c2 * sign, pc, ps))
    return tuple(terms) if terms else ((0.0, 0, 0),)


def _build_tables(ls: np.ndarray, ms: np.ndarray, s: int = -2):
    """Padded (coef, pow_cos, pow_sin) tables for a static mode list."""
    all_terms = [_ylm_terms(int(l), int(m), s) for l, m in zip(ls, ms)]
    kmax = max(len(t) for t in all_terms)
    coef = np.zeros((len(all_terms), kmax))
    pc = np.zeros((len(all_terms), kmax), dtype=np.int32)
    ps = np.zeros((len(all_terms), kmax), dtype=np.int32)
    for i, terms in enumerate(all_terms):
        for k, (c, a, b) in enumerate(terms):
            coef[i, k] = c
            pc[i, k] = a
            ps[i, k] = b
    return coef, pc, ps


def spin_weighted_ylm(
    ls, ms, theta: jax.Array, phi: jax.Array, s: int = -2
) -> tuple[jax.Array, jax.Array]:
    """sY_lm(theta, phi) for a static (l, m) list.

    ``ls``/``ms`` must be concrete (python/numpy) — they index precomputed
    tables; ``theta``/``phi`` may be traced scalars or arrays (broadcast
    against each other). Returns (re, im), each of shape
    ``broadcast(theta, phi).shape + (n_modes,)``.
    """
    ls = np.asarray(ls, dtype=np.int64)
    ms = np.asarray(ms, dtype=np.int64)
    coef, pc, ps = _build_tables(ls, ms, s)
    coef = jnp.asarray(coef)  # (M, K)
    theta, phi = jnp.broadcast_arrays(jnp.asarray(theta), jnp.asarray(phi))
    c2 = jnp.cos(theta / 2.0)[..., None, None]  # (..., 1, 1)
    s2 = jnp.sin(theta / 2.0)[..., None, None]
    # integer powers via where-guarded exponentials would NaN at 0; use
    # jnp.power with integer exponent arrays (0^0 == 1 semantics).
    mag = jnp.sum(coef * jnp.power(c2, jnp.asarray(pc)) * jnp.power(s2, jnp.asarray(ps)), axis=-1)
    m_arr = jnp.asarray(ms.astype(np.float64))  # (M,)
    mphi = m_arr * phi[..., None]
    return mag * jnp.cos(mphi), mag * jnp.sin(mphi)


class GetYlms:
    """Facade pinning the reference API (returns complex, CPU-friendly).

    With ``assume_positive_m=True``, calling with (l, m>=0) arrays returns the
    2*n array ``[Y_{l,m}..., Y_{l,-m}...]`` exactly like the reference
    generator (notebook cell 5 usage ``ylm_gen(...)[inverse_lm]``).
    """

    def __init__(self, assume_positive_m: bool = False, use_gpu: bool = None):
        del use_gpu  # device placement is jax's job
        self.assume_positive_m = assume_positive_m

    def __call__(self, ls, ms, theta, phi):
        ls = np.asarray(ls)
        ms = np.asarray(ms)
        if self.assume_positive_m:
            ls = np.concatenate([ls, ls])
            ms = np.concatenate([ms, -ms])
        re, im = spin_weighted_ylm(ls, ms, jnp.asarray(theta), jnp.asarray(phi))
        return np.asarray(re) + 1j * np.asarray(im)


__all__ = ["spin_weighted_ylm", "GetYlms"]
