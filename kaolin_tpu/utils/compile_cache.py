"""Persistent XLA compilation cache at one fixed place."""

import os

__all__ = ['enable_compile_cache']

_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), '.jax_cache')


def enable_compile_cache():
    """Keep compiled programs across processes; returns the cache path.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and nothing is
    set here.  Otherwise the cache lives at ``<repo>/.jax_cache``: a fixed
    path, because the path is part of the cache key.
    """
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    import jax
    jax.config.update('jax_compilation_cache_dir', _REPO_CACHE)
    return _REPO_CACHE
