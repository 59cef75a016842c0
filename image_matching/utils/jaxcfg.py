"""Shared JAX configuration: the persistent compilation cache.

The scenario graphs take minutes to compile and are fully reusable across
runs.  The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when it is
set (JAX reads that variable itself), and otherwise at one fixed path inside
the checkout, ``<checkout>/.jax_cache`` (git-ignored): the path is part of
the cache key, so a directory that moves never hits."""

import os

CHECKOUT_CACHE = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache"))


def compilation_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE


def enable_compilation_cache() -> str:
    """Point JAX's persistent cache at `compilation_cache_dir()` and cache
    every entry (small segments recompile often too).  Returns the path."""
    import jax

    path = compilation_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
