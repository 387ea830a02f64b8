"""Framework configuration: the persistent XLA compilation cache.

The reference's "config system" is compile-time template parameters and
#defines (SURVEY.md §5); here configuration is runtime but explicit.

The codec compiles one program per block shape, and the GPU kernels add a
Triton compile to each.  The cache lets every process after the first
skip them:

* if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses that directory and
  nothing here changes;
* otherwise the cache lives at ``<checkout>/.jax_cache``, a fixed path
  (the path is part of the cache key) that ``.gitignore`` lists.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def setup_compilation_cache() -> None:
    """Point JAX's persistent compilation cache at `CACHE_DIR` unless
    ``JAX_COMPILATION_CACHE_DIR`` already names one."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
