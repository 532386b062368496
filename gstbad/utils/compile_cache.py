"""JAX's persistent compilation cache at a fixed place.

The cache key includes the cache path, so a directory that moves between
runs never hits.  JAX itself reads `JAX_COMPILATION_CACHE_DIR`; when that
variable is unset, the cache lives at `<repo>/.jax_cache` (listed in
.gitignore).
"""

from __future__ import annotations

import os

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(_REPO, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
