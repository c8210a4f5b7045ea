"""JAX's persistent compilation cache, shared by every entry point.

A process that finds an executable in the cache skips XLA's compilation and
reuses the choices XLA's autotuner made when it was compiled. The cache is
keyed by its path among other things, so the path must not move between
runs: it is ``JAX_COMPILATION_CACHE_DIR`` where that is set, and otherwise,
when the package runs from a source checkout, one fixed directory at the
root of that checkout. An installed package with the variable unset keeps
JAX's own setting.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = Path(__file__).resolve().parents[2]
DEFAULT_DIR = CHECKOUT / ".jax_cache"


def enable_compile_cache() -> str | None:
    """Turn on the persistent cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX has read it already and
    nothing is changed. Outside a source checkout (no ``pyproject.toml``
    beside the package) nothing is changed either, and None is returned.
    Call this before the process compiles anything: JAX fixes the cache's
    location at its first compilation.
    """
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    if not (CHECKOUT / "pyproject.toml").is_file():
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
