"""Persistent JAX compilation cache for the benches and the smoke script.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there and
nothing here overrides it.  Otherwise the cache goes to a fixed directory
inside the checkout (the path is part of the cache key, so it must not
move between runs).  Tests never enable it.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import jax

DEFAULT_DIR = os.path.normpath(os.path.join(os.path.dirname(__file__), "..",
                                            "..", ".jax_cache"))


def cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """The directory the cache uses under ``environ`` (default: os.environ)."""
    env = os.environ if environ is None else environ
    return env.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str:
    """Turns the persistent cache on; returns its directory."""
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
