"""JAX persistent compilation cache location, shared by every entry point.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and no other
directory is set here. Otherwise the cache lives at a fixed directory inside
the checkout (`<repo>/.jax_cache`, listed in `.gitignore`): the path is part
of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable(min_compile_secs: float = 1.0) -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return path
