"""JAX persistent compilation cache for the repository's entry scripts.

Called by ``chip_smoke.py``, the ``bench.py`` stage processes and the
examples — never on library import, so importing the package changes no
JAX setting.
"""

from __future__ import annotations

import os

import jax

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

#: ``<checkout>/.jax_cache``: a fixed path, because the directory is part of
#: what makes a later process find the entries again
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache():
    """Use the persistent compilation cache in this process; returns its
    directory.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
    reads it and nothing is changed; otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
