"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the CLI, ``bench.py``, ``chip_smoke.py``):

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and the program
  sets no cache directory.
* unset: the cache goes to ``.jax_cache/`` at the root of the checkout.
  The path is fixed (it is part of the cache key) and stays inside the
  checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import os
from typing import Optional

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> Optional[str]:
    """The directory the program sets, or None when the environment
    already names one."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Apply :func:`cache_dir`; call before the first compilation.
    Returns the directory set, or None if the environment's is used."""
    import jax

    d = cache_dir()
    if d is not None:
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    return d
