"""Where JAX keeps its persistent compilation cache."""

from __future__ import annotations

import os
from pathlib import Path

# <repo>/.jax_cache, fixed by this file's location: the cache key
# includes the directory, so a path that moved with the working
# directory would never hit.
REPO_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here.  Otherwise the cache is ``<repo>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
