"""Mode selection: keep the strongest (l, m, n) harmonics.

Replaces the reference engine's ``few.utils.modeselector.ModeSelector``
(contract pinned at reference ``emri_pe.py:659-663`` — ``eps`` threads through
the waveform call keeping modes that carry cumulative power >= 1 - eps — and
notebook cells 2/7/15: explicit ``mode_selection=[(l,m,n)]`` lists with
``include_minus_m``).

Shape discipline: selection must not create dynamic shapes. We compact to
a static ``k_max`` strongest modes with `jax.lax.top_k` (k_max chosen at trace
time), then apply the eps cumulative-power criterion as a *mask* over that
static axis. Downstream kernels scan exactly ``k_max`` modes; masked lanes
contribute zeros. ``eps`` therefore behaves identically to the reference for
any k_max large enough to cover the kept set (the default table has 91
candidate modes; k_max=64 covers eps=1e-2 comfortably).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .amplitude import ModeTable


class SelectedModes(NamedTuple):
    """Static-size compacted mode set.

    Attributes:
      idx: (k_max,) int32 indices into the candidate ModeTable, strongest
        first (padded by repeating the strongest index with mask=0).
      mask: (k_max,) float (1.0 keep / 0.0 drop) applying the eps criterion.
      power: (k_max,) selected per-mode power (diagnostics).
    """

    idx: jax.Array
    mask: jax.Array
    power: jax.Array


def mode_power(
    a_re: jax.Array,
    a_im: jax.Array,
    y_plus_re: jax.Array,
    y_plus_im: jax.Array,
    y_minus_re: jax.Array,
    y_minus_im: jax.Array,
    dt_weights: jax.Array | None = None,
) -> jax.Array:
    """Per-mode power sum_k |A_km|^2 (|Y_{lm}|^2 + |Y_{l,-m}|^2).

    ``a_re/a_im``: (knots, M); Ylm factors: (M,). Matches the reference
    selector's power metric (amplitude magnitude weighted by the viewing
    harmonics, summed along the trajectory). ``dt_weights`` (knots,) allows
    time-weighted sums (masking padded knots).
    """
    mag2 = a_re * a_re + a_im * a_im
    if dt_weights is not None:
        mag2 = mag2 * dt_weights[:, None]
    ywt = y_plus_re**2 + y_plus_im**2 + y_minus_re**2 + y_minus_im**2
    return jnp.sum(mag2, axis=0) * ywt


def select_modes(
    power: jax.Array, k_max: int, eps: float, order_key: jax.Array | None = None
) -> SelectedModes:
    """Top-k_max modes by power, masked to cumulative fraction >= 1 - eps.

    ``order_key``: optional (n_candidates,) per-mode sort key (e.g. the
    band-start frequency). When given, the SELECTED modes are reordered
    ascending in this key so slot k has a stable physical identity across a
    vmapped batch — what lets the banded FD kernel share per-slot window
    offsets across walkers whose top-k sets differ slightly (see
    `summation_fd.fd_mode_sum_uniform`). Dead (masked) slots sort last.
    """
    k_max = min(k_max, power.shape[-1])
    p_top, idx = jax.lax.top_k(power, k_max)
    total = jnp.sum(power, axis=-1, keepdims=False)
    cum = jnp.cumsum(p_top, axis=-1)
    # keep mode i if the cumulative power *before* it is < (1-eps)*total
    cum_before = cum - p_top
    mask = (cum_before < (1.0 - eps) * total).astype(power.dtype)
    if order_key is not None:
        key = jnp.where(mask > 0, jnp.take(order_key, idx), jnp.inf)
        order = jnp.argsort(key)
        idx = jnp.take(idx, order)
        mask = jnp.take(mask, order)
        p_top = jnp.take(p_top, order)
    return SelectedModes(idx=idx.astype(jnp.int32), mask=mask, power=p_top)


class ModeSelector:
    """Facade pinning the reference selector's call shape.

    ``selector(teuk_modes, ylms, modeinds, eps=...)`` in the reference; here a
    simplified ``(a_re, a_im, ylm_pairs, eps, k_max)`` -> SelectedModes.
    """

    def __init__(self, table: ModeTable, k_max: int = 64):
        self.table = table
        self.k_max = k_max

    def __call__(self, a_re, a_im, y_pr, y_pi, y_mr, y_mi, eps: float = 1e-5):
        power = mode_power(a_re, a_im, y_pr, y_pi, y_mr, y_mi)
        return select_modes(power, self.k_max, eps)


def table_indices_for(table: ModeTable, requested: list[tuple[int, int, int]]) -> np.ndarray:
    """Host-side lookup of explicit ``mode_selection`` entries in the table."""
    lookup = {
        (int(l), int(m), int(n)): i
        for i, (l, m, n) in enumerate(zip(table.ls, table.ms, table.ns))
    }
    out = []
    for lmn in requested:
        if lmn not in lookup:
            raise KeyError(f"mode {lmn} not in candidate table")
        out.append(lookup[lmn])
    return np.asarray(out, dtype=np.int32)


__all__ = ["SelectedModes", "mode_power", "select_modes", "ModeSelector", "table_indices_for"]
