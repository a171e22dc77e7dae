"""Persistent XLA compilation cache.

When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
set here. Otherwise the cache lives at one fixed path inside the checkout
(`<repo>/.jax_cache`, listed in .gitignore): the directory is part of the
cache key, so a path that moved between runs would never hit. Called by
bench.py, chip_smoke.py and the CLI.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str | None:
    """The directory this program sets, or None when the environment
    already names one."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return REPO_CACHE_DIR


def enable_compilation_cache() -> None:
    import jax

    path = cache_dir()
    if path is not None:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
