"""Where the program keeps what it caches: one fixed place per checkout.

JAX's persistent compilation cache keys on the directory path, so a
directory that moves never hits.  ``JAX_COMPILATION_CACHE_DIR``, when set,
wins and JAX reads it itself; otherwise the cache lives in
``<checkout>/.jax_cache`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def checkout_dir() -> str:
    """The repository checkout that holds this package."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """The compile-cache directory: ``$JAX_COMPILATION_CACHE_DIR`` if set,
    else ``<checkout>/.jax_cache``."""
    return os.environ.get(ENV_VAR) or os.path.join(checkout_dir(),
                                                   ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.
    With the environment variable set, JAX already uses it and no other
    directory is set here."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
