"""Alternative amplitude backends: grid interpolation and a learned network.

Mirrors the reference engine's two data-driven amplitude modules behind the
same interface as `models.amplitude.mode_amplitudes`:

* `Interp2DAmplitude` — bicubic interpolation over a regular grid in the
  separatrix-adapted coordinates ``(u, e)`` with ``u = log(p - 6 - 2e + 0.5)``
  (reference ``few.amplitude.interp2dcubicspline.Interp2DAmplitude``, a C++
  bicubic over Teukolsky data; notebook cell 2). Pass
  ``source=models.amplitude.full_fidelity_amplitudes`` to
  `build_amplitude_grid` to tabulate the repo's highest physics rung
  (tail + factorized + RWZ strong-field calibration — the
  solver-computed equivalent of the reference's Teukolsky table);
  externally computed tables of the same layout also drop in without
  touching the waveform pipeline.
* `RomanAmplitude` — a small MLP ``(u, e) -> A_lmn`` (reference
  ``few.amplitude.romannet.RomanAmplitude``, a CUDA reduced-order network).
  Here the matmuls land on the matrix units; `fit_roman_network` trains the weights
  against any amplitude backend with optax.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.interp2d import interp2d_bicubic
from .amplitude import ModeTable, default_mode_table, mode_amplitudes
from .geodesic import separatrix

_U_SHIFT = 0.5


def u_of_pe(p, e):
    return jnp.log(p - separatrix(e) + _U_SHIFT)


class AmplitudeGrid(NamedTuple):
    """Regular (u, e) amplitude table for a static mode inventory."""

    u0: float
    du: float
    e0: float
    de: float
    values: jax.Array  # (nu, ne, n_modes, 2) re/im
    table: ModeTable


def build_amplitude_grid(
    table: ModeTable | None = None,
    *,
    u_range=(np.log(_U_SHIFT + 0.05), np.log(16.0)),
    e_range=(1e-6, 0.75),
    n_u: int = 64,
    n_e: int = 33,
    source=mode_amplitudes,
) -> AmplitudeGrid:
    """Tabulate ``source(p, e, table)`` on a regular (u, e) grid."""
    table = table or default_mode_table()
    us = np.linspace(u_range[0], u_range[1], n_u)
    es = np.linspace(e_range[0], e_range[1], n_e)
    uu, ee = np.meshgrid(us, es, indexing="ij")
    pp = np.exp(uu) - _U_SHIFT + 6.0 + 2.0 * ee
    re, im = source(jnp.asarray(pp.ravel()), jnp.asarray(ee.ravel()), table)
    vals = jnp.stack([re, im], axis=-1).reshape(n_u, n_e, table.num_modes, 2)
    return AmplitudeGrid(
        u0=float(us[0]),
        du=float(us[1] - us[0]),
        e0=float(es[0]),
        de=float(es[1] - es[0]),
        values=vals,
        table=table,
    )


def mode_amplitudes_interp2d(p, e, grid: AmplitudeGrid):
    """Grid-backend evaluation matching `mode_amplitudes`' signature."""
    u = u_of_pe(jnp.asarray(p), jnp.asarray(e))
    out = interp2d_bicubic(
        grid.u0, grid.du, grid.e0, grid.de, grid.values, u, jnp.asarray(e)
    )
    return out[..., 0], out[..., 1]


class Interp2DAmplitude:
    """OO facade pinning the reference interp-amplitude call contract."""

    def __init__(self, grid: AmplitudeGrid | None = None, **kwargs):
        del kwargs
        self.grid = grid or build_amplitude_grid()

    def __call__(self, p, e, specific_modes=None):
        re, im = mode_amplitudes_interp2d(jnp.asarray(p), jnp.asarray(e), self.grid)
        table = self.grid.table
        lookup = {
            (int(l), int(m), int(n)): i
            for i, (l, m, n) in enumerate(zip(table.ls, table.ms, table.ns))
        }
        modes = specific_modes or list(lookup)
        out = {}
        for lmn in modes:
            l, m, n = lmn
            if m < 0:
                i = lookup[(l, -m, -n)]
                a = np.asarray(re[..., i]) + 1j * np.asarray(im[..., i])
                out[lmn] = ((-1.0) ** l) * np.conj(a)
            else:
                i = lookup[lmn]
                out[lmn] = np.asarray(re[..., i]) + 1j * np.asarray(im[..., i])
        return out


class RomanParams(NamedTuple):
    weights: tuple
    biases: tuple
    table: ModeTable
    scale: jax.Array  # per-mode output scaling (re, im)


def init_roman_network(
    table: ModeTable | None = None, hidden=(64, 64, 64), seed: int = 0
) -> RomanParams:
    table = table or default_mode_table()
    sizes = (2,) + tuple(hidden) + (2 * table.num_modes,)
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for a, b in zip(sizes[:-1], sizes[1:]):
        ws.append(jnp.asarray(rng.normal(0, np.sqrt(2.0 / a), (a, b))))
        bs.append(jnp.zeros((b,)))
    return RomanParams(tuple(ws), tuple(bs), table, jnp.ones((2 * table.num_modes,)))


def roman_forward(params: RomanParams, p, e):
    """MLP amplitudes -> (re, im), each (..., n_modes)."""
    u = u_of_pe(jnp.asarray(p), jnp.asarray(e))
    x = jnp.stack([u, jnp.asarray(e)], axis=-1)
    for w, b in zip(params.weights[:-1], params.biases[:-1]):
        x = jnp.tanh(x @ w + b)
    x = x @ params.weights[-1] + params.biases[-1]
    x = x * params.scale
    n = params.table.num_modes
    return x[..., :n], x[..., n:]


def fit_roman_network(
    params: RomanParams,
    *,
    n_steps: int = 2000,
    batch: int = 512,
    lr: float = 3e-3,
    seed: int = 1,
    u_range=(np.log(_U_SHIFT + 0.05), np.log(12.0)),
    e_range=(1e-4, 0.7),
    source=mode_amplitudes,
    verbose: bool = False,
) -> RomanParams:
    """Train the network against an amplitude source (optax adam)."""
    import optax

    table = params.table
    rng = np.random.default_rng(seed)
    # output scaling: normalize per-mode magnitudes on a probe set
    up = rng.uniform(*u_range, 2048)
    ep = rng.uniform(*e_range, 2048)
    pp = np.exp(up) - _U_SHIFT + 6.0 + 2.0 * ep
    re, im = source(jnp.asarray(pp), jnp.asarray(ep), table)
    mag = jnp.maximum(
        jnp.concatenate([jnp.max(jnp.abs(re), 0), jnp.max(jnp.abs(im), 0)]), 1e-12
    )
    params = params._replace(scale=mag)

    opt = optax.adam(lr)
    trainable = (params.weights, params.biases)
    opt_state = opt.init(trainable)

    def loss_fn(trainable, pq, eq, target_re, target_im):
        ws, bs = trainable
        pr = params._replace(weights=ws, biases=bs)
        mre, mim = roman_forward(pr, pq, eq)
        n = table.num_modes
        return jnp.mean(
            ((mre - target_re) / mag[:n]) ** 2 + ((mim - target_im) / mag[n:]) ** 2
        )

    @jax.jit
    def step(trainable, opt_state, pq, eq, tr, ti):
        loss, grads = jax.value_and_grad(loss_fn)(trainable, pq, eq, tr, ti)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(trainable, updates), opt_state, loss

    for i in range(n_steps):
        ub = rng.uniform(*u_range, batch)
        eb = rng.uniform(*e_range, batch)
        pb = np.exp(ub) - _U_SHIFT + 6.0 + 2.0 * eb
        tr, ti = source(jnp.asarray(pb), jnp.asarray(eb), table)
        trainable, opt_state, loss = step(trainable, opt_state, jnp.asarray(pb), jnp.asarray(eb), tr, ti)
        if verbose and i % 200 == 0:
            print(f"roman fit step {i}: loss {float(loss):.3e}")
    ws, bs = trainable
    return params._replace(weights=ws, biases=bs)


class RomanAmplitude:
    """OO facade pinning the reference ROMAN-net call contract."""

    def __init__(self, params: RomanParams | None = None, **kwargs):
        del kwargs
        self.params = params or init_roman_network()

    def __call__(self, p, e, specific_modes=None):
        re, im = roman_forward(self.params, jnp.asarray(p), jnp.asarray(e))
        table = self.params.table
        lookup = {
            (int(l), int(m), int(n)): i
            for i, (l, m, n) in enumerate(zip(table.ls, table.ms, table.ns))
        }
        modes = specific_modes or list(lookup)
        out = {}
        for lmn in modes:
            l, m, n = lmn
            if m < 0:
                i = lookup[(l, -m, -n)]
                a = np.asarray(re[..., i]) + 1j * np.asarray(im[..., i])
                out[lmn] = ((-1.0) ** l) * np.conj(a)
            else:
                i = lookup[lmn]
                out[lmn] = np.asarray(re[..., i]) + 1j * np.asarray(im[..., i])
        return out


__all__ = [
    "AmplitudeGrid",
    "build_amplitude_grid",
    "mode_amplitudes_interp2d",
    "Interp2DAmplitude",
    "RomanParams",
    "init_roman_network",
    "roman_forward",
    "fit_roman_network",
    "RomanAmplitude",
]
