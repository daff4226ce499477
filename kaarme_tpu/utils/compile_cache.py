"""Placement of JAX's persistent compilation cache.

One helper for every entry point (the CLI, ``bench.py``,
``chip_smoke.py``), so all of them share one cache and a later run finds
what an earlier one compiled.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# fixed, gitignored directory at the root of the checkout
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    no other directory is set here.  Otherwise the cache goes to
    ``DEFAULT_DIR``."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
