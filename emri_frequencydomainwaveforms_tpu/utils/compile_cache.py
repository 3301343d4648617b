"""Where the persistent XLA compile cache lives, for every entry point.

The benchmark, both CLIs, ``chip_smoke.py`` and the test suite compile the
same large programs; a cache at a fixed path lets one run reuse what another
compiled (the path is part of the cache key, so it must not move).
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it and nothing
    is changed here; otherwise the cache goes to ``<checkout>/.jax_cache``.
    """
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE


__all__ = ["enable_compile_cache"]
