"""Batched tridiagonal solver (Thomas algorithm) as a `lax.scan`.

JAX replacement for the cuSPARSE tridiagonal solve the reference's
external engine uses inside ``few.summation.interpolatedmodesum.CubicSplineInterpolant``
(behavior pinned at reference ``Tutorial_FD_construction_single_mode.ipynb``
cells 8-9, 20-21). The scan is sequential in the knot axis (~100 knots) but
fully vectorized across the batch axis, which is where the parallelism is
(modes x sources).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def thomas_solve(dl: jax.Array, d: jax.Array, du: jax.Array, b: jax.Array) -> jax.Array:
    """Solve tridiagonal systems ``A x = b``.

    Args:
      dl: sub-diagonal, shape ``(..., n)`` with ``dl[..., 0]`` ignored.
      d:  main diagonal, shape ``(..., n)``.
      du: super-diagonal, shape ``(..., n)`` with ``du[..., -1]`` ignored.
      b:  right-hand side, shape ``(..., n)``.

    Returns:
      x with shape ``(..., n)``. Batch dims broadcast; the solve is along the
      last axis via two `lax.scan` sweeps (forward elimination, back subst).
    """
    dl, d, du, b = jnp.broadcast_arrays(dl, d, du, b)
    n = d.shape[-1]

    # Move the solve axis to the front for scanning: (n, batch...)
    dl_t = jnp.moveaxis(dl, -1, 0)
    d_t = jnp.moveaxis(d, -1, 0)
    du_t = jnp.moveaxis(du, -1, 0)
    b_t = jnp.moveaxis(b, -1, 0)

    # Forward sweep: c'_i = du_i / (d_i - dl_i c'_{i-1}),
    #                g_i  = (b_i - dl_i g_{i-1}) / (d_i - dl_i c'_{i-1})
    def fwd(carry, row):
        c_prev, g_prev = carry
        dl_i, d_i, du_i, b_i = row
        denom = d_i - dl_i * c_prev
        c_i = du_i / denom
        g_i = (b_i - dl_i * g_prev) / denom
        return (c_i, g_i), (c_i, g_i)

    zeros = jnp.zeros_like(d_t[0])
    (_, _), (c, g) = jax.lax.scan(fwd, (zeros, zeros), (dl_t, d_t, du_t, b_t))

    # Back substitution: x_i = g_i - c'_i x_{i+1}
    def bwd(x_next, row):
        c_i, g_i = row
        x_i = g_i - c_i * x_next
        return x_i, x_i

    _, x_rev = jax.lax.scan(bwd, zeros, (c, g), reverse=True)
    return jnp.moveaxis(x_rev, 0, -1)


__all__ = ["thomas_solve"]
