"""Device-mesh sharding helpers (walker / frequency axes).

The reference is single-process single-GPU (SURVEY §2.5: no NCCL/MPI; its
only "parallelism" is in-process walker batching + a CPU multiprocessing
pool). The scaling axes here are:

* **walkers** (data-parallel): each chip evaluates the likelihood of its
  walker shard; ensemble-move logic is cheap and uses XLA collectives
  inserted automatically by GSPMD when proposals mix walkers across shards;
* **frequency** (sequence-parallel analogue): FD bins are independent given
  the per-mode spline data — shard the output grid, `all_gather` only final
  spectra (useful for full-grid generation at very large Nf).

Helpers here build the mesh and shardings; computations stay ordinary jitted
functions — `jax.jit` + `NamedSharding` constraints do the distribution.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def walker_mesh(n_devices: int | None = None, axis: str = "walkers") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def shard_walkers(mesh: Mesh, axis: str = "walkers") -> NamedSharding:
    """Sharding for (nwalkers, ...) arrays: leading axis across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_frequency(mesh: Mesh, axis: str = "walkers") -> NamedSharding:
    """Sharding for (..., Nf) spectra: last axis across the mesh."""
    return NamedSharding(mesh, P(None, axis))


__all__ = ["walker_mesh", "shard_walkers", "replicated", "shard_frequency"]
