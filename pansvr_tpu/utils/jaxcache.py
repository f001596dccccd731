"""Persistent jit cache location.

Where JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and nothing
here overrides it. Otherwise the cache lives at one fixed directory
inside the checkout, `<repo>/.jax_cache` (listed in .gitignore): the
cache key includes the path, so a directory that moved would never hit,
and every process of one checkout (test workers, fan-out subprocesses)
resolves the same one.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")

_done = False


def enable_cache() -> str:
    """Point jax's persistent cache at JAX_COMPILATION_CACHE_DIR when it
    is set (jax reads it itself), else at REPO_CACHE_DIR, and cache every
    executable regardless of its size or compile time. Idempotent;
    returns the directory in use."""
    global _done
    d = os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR
    if _done:
        return d
    _done = True
    import jax

    if d == REPO_CACHE_DIR:
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return d
