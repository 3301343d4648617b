"""Bicubic interpolation on regular 2-D grids (jittable, batched).

JAX counterpart of the reference engine's C++ bicubic amplitude
interpolant (``few.amplitude.interp2dcubicspline.Interp2DAmplitude``,
reference notebook cell 2). Uses Catmull-Rom bicubic patches (local 4x4
stencils — gather-light, no global solves, C^1): amplitude surfaces are
smooth, so local cubics match global bicubic splines to the grid-resolution
error floor.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _cr_weights(t):
    """Catmull-Rom basis weights for the 4-point stencil at parameter t."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return w0, w1, w2, w3


def interp2d_bicubic(
    x0: float,
    dx: float,
    y0: float,
    dy: float,
    values: jax.Array,  # (nx, ny, ...) grid data
    xq: jax.Array,
    yq: jax.Array,
) -> jax.Array:
    """Catmull-Rom bicubic interpolation of ``values`` at (xq, yq).

    The grid is uniform: ``x_i = x0 + i dx``, ``y_j = y0 + j dy``. Queries
    are clamped to the valid interior. Trailing dims of ``values`` ride
    along; output shape = broadcast(xq, yq).shape + values.shape[2:].
    """
    nx, ny = values.shape[0], values.shape[1]
    fx = (jnp.asarray(xq) - x0) / dx
    fy = (jnp.asarray(yq) - y0) / dy
    ix = jnp.clip(jnp.floor(fx).astype(jnp.int32), 1, nx - 3)
    iy = jnp.clip(jnp.floor(fy).astype(jnp.int32), 1, ny - 3)
    tx = jnp.clip(fx - ix, -1.0, 2.0)
    ty = jnp.clip(fy - iy, -1.0, 2.0)

    wx = _cr_weights(tx)
    wy = _cr_weights(ty)

    extra = (1,) * (values.ndim - 2)
    out = 0.0
    for a in range(4):
        row = 0.0
        for b in range(4):
            v = values[ix + a - 1, iy + b - 1]
            row = row + wy[b].reshape(wy[b].shape + extra) * v
        out = out + wx[a].reshape(wx[a].shape + extra) * row
    return out


def interp2d_bicubic_dense(
    x0: float,
    dx: float,
    y0: float,
    dy: float,
    values: jax.Array,  # (nx, ny, ...) grid data
    xq: jax.Array,
    yq: jax.Array,
) -> jax.Array:
    """Gather-free evaluation of the SAME Catmull-Rom bicubic surface.

    Mathematically identical to :func:`interp2d_bicubic` (same stencil
    indices, same clamps, same CR weights — differences are reduction-order
    ULPs only; pinned by ``tests/test_interp2d_dense.py``): the 4-point
    stencil weights are scattered into dense cardinal weight vectors over
    the full grid axes and contracted against the table with einsums. This
    trades 16 random gathers per query for two dense contractions, which
    pays only when the query batch is large relative to the table (the
    rwz-calibration pattern); for tiny per-step query batches against the
    (96, 49) flux grid inside the sequential DP5 while_loop the contraction
    is latency-bound exactly where the gathers were. It is off the
    production path (ROADMAP Design item 7). Stays in the table dtype.

    Non-finite grid entries are sanitized to 0 before the contraction:
    unlike the gather path (which only ever touches the 4x4 stencil), the
    dense einsum multiplies zero weights against the ENTIRE table, and
    0 * nan = nan would poison every query.
    """
    nx, ny = values.shape[0], values.shape[1]
    fx = (jnp.asarray(xq) - x0) / dx
    fy = (jnp.asarray(yq) - y0) / dy
    ix = jnp.clip(jnp.floor(fx).astype(jnp.int32), 1, nx - 3)
    iy = jnp.clip(jnp.floor(fy).astype(jnp.int32), 1, ny - 3)
    tx = jnp.clip(fx - ix, -1.0, 2.0)
    ty = jnp.clip(fy - iy, -1.0, 2.0)

    dt = values.dtype
    wx = jnp.stack(_cr_weights(tx), axis=-1).astype(dt)  # (..., 4)
    wy = jnp.stack(_cr_weights(ty), axis=-1).astype(dt)  # (..., 4)
    offs = jnp.arange(-1, 3, dtype=jnp.int32)
    # dense cardinal vectors: wvx[..., k] = sum_a wx[..., a] * [k == ix+a-1]
    # (exact zeros off-stencil, so the contraction reproduces the stencil
    # sum up to reduction order)
    kx = jnp.arange(nx, dtype=jnp.int32)
    ky = jnp.arange(ny, dtype=jnp.int32)
    selx = (ix[..., None] + offs)[..., :, None] == kx  # (..., 4, nx)
    sely = (iy[..., None] + offs)[..., :, None] == ky  # (..., 4, ny)
    wvx = jnp.sum(jnp.where(selx, wx[..., :, None], jnp.zeros((), dt)), axis=-2)
    wvy = jnp.sum(jnp.where(sely, wy[..., :, None], jnp.zeros((), dt)), axis=-2)

    values = jnp.where(jnp.isfinite(values), values, jnp.zeros((), dt))
    vflat = values.reshape(nx, ny, -1)
    # y-inner like the gather path, then x — two dense contractions
    # HIGHEST: a default-precision f32 contraction may run in TF32 on the GPU
    hi = jax.lax.Precision.HIGHEST
    tmp = jnp.einsum("...l,klc->...kc", wvy, vflat, precision=hi)
    out = jnp.einsum("...k,...kc->...c", wvx, tmp, precision=hi)
    return out.reshape(out.shape[:-1] + values.shape[2:])


__all__ = ["interp2d_bicubic", "interp2d_bicubic_dense"]
