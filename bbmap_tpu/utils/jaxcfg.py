"""JAX runtime configuration helpers."""

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# one fixed directory inside the checkout (listed in .gitignore): the
# cache key includes nothing path-dependent, but a directory that moves
# between runs never hits
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compilation_cache_dir() -> str:
    """Where compiled programs persist: ``$JAX_COMPILATION_CACHE_DIR``
    when set, else the checkout's ``.jax_cache``."""
    return os.environ.get(CACHE_ENV) or REPO_CACHE_DIR


def enable_compilation_cache() -> str:
    """Persist compiled XLA programs across processes (the fused pair
    program takes tens of seconds to compile). When
    ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself and no
    other directory is set here. Returns the directory in use."""
    import jax
    path = compilation_cache_dir()
    if not os.environ.get(CACHE_ENV):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
