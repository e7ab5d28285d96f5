"""Persistent XLA compilation cache.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing
is set here.  Otherwise the cache lives at the fixed `<checkout>/.jax_cache`
(the path is part of the cache key, so a moving directory never hits).
Call `enable()` from every entry point that compiles the step (bench, CLI
run, chip_smoke.py).
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable() -> str:
    """Turn the cache on; returns the directory it uses."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
