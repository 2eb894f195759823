"""The one place that decides JAX's persistent compile cache.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing here
sets anything. Otherwise the cache lives at a fixed path inside the
checkout (`<checkout>/.jax_cache`, or the caller's own fixed default), so
that every process of this repository finds what another compiled: the
path is part of the cache's key, and a directory that moves never hits.
"""

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def setup_compile_cache(default: str = DEFAULT_DIR) -> str:
    """Enable the persistent compile cache → its directory.

    Call before the first compile. With `JAX_COMPILATION_CACHE_DIR` set this
    only reports it; without, it points JAX at `default` and caches every
    program that took at least 2 s to compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", default)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return default
