"""Where the program keeps what it builds at run time.

Everything lives under ``.cache/`` at the root of the checkout (listed
in ``.gitignore``), so nothing is written around it:

* ``.cache/jax`` — XLA's persistent compilation cache.  The path is
  part of the cache key, so it is fixed; ``JAX_COMPILATION_CACHE_DIR``
  takes its place when set.
* ``.cache/native`` — the ctypes library built from
  ``solstice/native/src`` (see :mod:`solstice.native`).
"""

from __future__ import annotations

import os

__all__ = ["CACHE_ROOT", "enable_compile_cache"]

CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".cache",
)


def enable_compile_cache(min_compile_secs: float = 1.0) -> None:
    """Turn on the persistent compile cache; every entry point calls
    this once, before its first compilation.

    With ``JAX_COMPILATION_CACHE_DIR`` set this sets nothing: JAX reads
    the variable itself.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(CACHE_ROOT, "jax"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
