"""Persistent compilation cache: one place decides whether and where.

The refine programs are large and recompile identically from run to run,
so on the GPU the compiled executables are kept on disk:

* where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it, and
  no other directory is set here;
* otherwise the cache sits at the fixed ``<checkout>/.jax_cache`` (a
  fixed path, because the path is part of the cache's key).

On the CPU backend the cache stays off: deserializing XLA:CPU executables
has segfaulted the interpreter (an executable built on a host with other
ISA extensions, and also same-host within one test run), and CPU compiles
are cheap.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_persistent_cache() -> str | None:
    """Configure JAX's persistent cache for the backend in use.

    Returns the cache directory, or None when the cache is off (CPU).
    Call before the first compile that should be cached.
    """
    import jax

    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_compilation_cache", False)
        return None
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path
