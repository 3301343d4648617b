"""TDI triple-observable container with channel algebra and likelihoods.

Rebuilds the reference's ``TDIf`` (reference
``LISAanalysistools/lisatools/sensitivity.py:99-371``): a frequency-domain
TDI (X, Y, Z) / (A, E, T) triple supporting elementwise algebra
(+, -, *, /, scalar multiples), lazily-evaluated channel PSDs, and the
noise-weighted reductions ``normsq`` / ``dotprod`` / ``cprod`` / ``logL``.

Differences from the reference:
* channels are stored as BOTH bases up front (A, E, T derived once from
  X, Y, Z or vice versa — the reference's lazy ``Xf`` attribute errors
  when constructed from AET; here both always exist);
* the container is a registered pytree (NamedTuple) over ``(re, im)``
  float pairs, so reductions jit/vmap without complex dtypes (a choice made
  for an accelerator without complex128; ROADMAP Design item 3); complex numpy arrays are accepted and returned at the host
  boundary;
* PSDs are computed host-side in numpy (LISA PSD magnitudes ~1e-40
  underflow an emulated double-float f64 — see `lisa.sensitivity`) and
  enter reductions as constants.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .sensitivity import noisepsd_AE, noisepsd_T, noisepsd_X, noisepsd_XY

_SQ2, _SQ3, _SQ6 = math.sqrt(2.0), math.sqrt(3.0), math.sqrt(6.0)


def _pair(x):
    """complex | (re, im) -> (re, im) jnp pair."""
    if isinstance(x, tuple):
        return jnp.asarray(x[0]), jnp.asarray(x[1])
    x = np.asarray(x)
    return jnp.asarray(x.real), jnp.asarray(x.imag)


class TDIf(NamedTuple):
    """Frequency-domain TDI triple; all six channels as (re, im) pairs."""

    f: jnp.ndarray  # (Nf,) positive frequencies
    X: tuple
    Y: tuple
    Z: tuple
    A: tuple
    E: tuple
    T: tuple

    # ---- constructors ----
    @classmethod
    def from_xyz(cls, f, X, Y, Z):
        X, Y, Z = _pair(X), _pair(Y), _pair(Z)
        A = tuple((z - x) / _SQ2 for x, z in zip(X, Z))
        E = tuple((x - 2.0 * y + z) / _SQ6 for x, y, z in zip(X, Y, Z))
        T = tuple((x + y + z) / _SQ3 for x, y, z in zip(X, Y, Z))
        return cls(jnp.asarray(f), X, Y, Z, A, E, T)

    @classmethod
    def from_aet(cls, f, A, E, T):
        A, E, T = _pair(A), _pair(E), _pair(T)
        # inverse of the orthogonal AET map
        X = tuple(-a / _SQ2 + e / _SQ6 + t / _SQ3 for a, e, t in zip(A, E, T))
        Y = tuple(-2.0 * e / _SQ6 + t / _SQ3 for e, t in zip(E, T))
        Z = tuple(a / _SQ2 + e / _SQ6 + t / _SQ3 for a, e, t in zip(A, E, T))
        return cls(jnp.asarray(f), X, Y, Z, A, E, T)

    # ---- host-boundary accessors ----
    @property
    def Xf(self):
        return np.asarray(self.X[0]) + 1j * np.asarray(self.X[1])

    @property
    def Af(self):
        return np.asarray(self.A[0]) + 1j * np.asarray(self.A[1])

    @property
    def Ef(self):
        return np.asarray(self.E[0]) + 1j * np.asarray(self.E[1])

    @property
    def Tf(self):
        return np.asarray(self.T[0]) + 1j * np.asarray(self.T[1])

    @property
    def df(self):
        # jnp so the reductions stay traceable under jit
        return self.f[1] - self.f[0] if self.f.shape[0] > 1 else jnp.asarray(1.0)

    def __len__(self):
        return self.f.shape[0]

    # ---- channel PSDs (host numpy; see module docstring) ----
    @property
    def Sae(self):
        return noisepsd_AE(np.asarray(self.f))

    @property
    def St(self):
        return noisepsd_T(np.asarray(self.f))

    @property
    def Sx(self):
        return noisepsd_X(np.asarray(self.f))

    @property
    def Sxy(self):
        return noisepsd_XY(np.asarray(self.f))

    # ---- elementwise algebra (reference :186-268) ----
    def _zip(self, other, op):
        if isinstance(other, TDIf):
            chans = {
                name: tuple(op(a, b) for a, b in zip(getattr(self, name), getattr(other, name)))
                for name in ("X", "Y", "Z", "A", "E", "T")
            }
        else:
            s = jnp.asarray(other)
            chans = {
                name: tuple(op(a, s) for a in getattr(self, name))
                for name in ("X", "Y", "Z", "A", "E", "T")
            }
        return TDIf(self.f, **chans)

    def __add__(self, other):
        return self._zip(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._zip(other, lambda a, b: a - b)

    def __mul__(self, other):
        if isinstance(other, TDIf):
            # complex elementwise product per channel
            chans = {}
            for name in ("X", "Y", "Z", "A", "E", "T"):
                ar, ai = getattr(self, name)
                br, bi = getattr(other, name)
                chans[name] = (ar * br - ai * bi, ar * bi + ai * br)
            return TDIf(self.f, **chans)
        return self._zip(other, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, TDIf):
            chans = {}
            for name in ("X", "Y", "Z", "A", "E", "T"):
                ar, ai = getattr(self, name)
                br, bi = getattr(other, name)
                den = br * br + bi * bi
                chans[name] = ((ar * br + ai * bi) / den, (ai * br - ar * bi) / den)
            return TDIf(self.f, **chans)
        return self._zip(other, lambda a, b: a / b)

    # ---- noise-weighted reductions (reference :270-347) ----
    def normsq(self, noisepsd=None, extranoise=(0.0, 0.0, 0.0)):
        """4 df sum |A|^2/SAE + |E|^2/SAE + |T|^2/ST (reference :270)."""
        if noisepsd is None:
            sa = jnp.asarray(self.Sae) + extranoise[0]
            se = jnp.asarray(self.Sae) + extranoise[1]
            st = jnp.asarray(self.St) + extranoise[2]
        else:
            sa, se, st = (jnp.asarray(p) for p in noisepsd)
        out = (
            jnp.sum((self.A[0] ** 2 + self.A[1] ** 2) / sa)
            + jnp.sum((self.E[0] ** 2 + self.E[1] ** 2) / se)
            + jnp.sum((self.T[0] ** 2 + self.T[1] ** 2) / st)
        )
        return 4.0 * self.df * out

    def normsqx(self, noisepsd=None):
        sx = jnp.asarray(self.Sx) if noisepsd is None else jnp.asarray(noisepsd)
        return 4.0 * self.df * jnp.sum((self.X[0] ** 2 + self.X[1] ** 2) / sx)

    def cprod(self, other: "TDIf"):
        """Complex noise-weighted inner product, returned as (re, im)."""
        sa = jnp.asarray(self.Sae)
        st = jnp.asarray(self.St)
        re = im = 0.0
        for name, s in (("A", sa), ("E", sa), ("T", st)):
            ar, ai = getattr(self, name)
            br, bi = getattr(other, name)
            re = re + jnp.sum((ar * br + ai * bi) / s)
            im = im + jnp.sum((ar * bi - ai * br) / s)
        return 4.0 * self.df * re, 4.0 * self.df * im

    def dotprod(self, other: "TDIf"):
        return self.cprod(other)[0]

    def dotprodx(self, other: "TDIf"):
        sx = jnp.asarray(self.Sx)
        ar, ai = self.X
        br, bi = other.X
        return 4.0 * self.df * jnp.sum((ar * br + ai * bi) / sx)

    def logL(self, other: "TDIf"):
        """-1/2 <d - h, d - h> over (A, E, T) (reference :337-347)."""
        return -0.5 * (self - other).normsq()


__all__ = ["TDIf"]
