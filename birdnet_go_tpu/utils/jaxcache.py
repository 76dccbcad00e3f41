"""One fixed location for JAX's persistent compilation cache.

The cache directory is part of every entry's lookup, so a directory that
moves between runs (a temporary name, a pid, a time stamp) never hits.
Entry points (`cli.main`, `bench.py`, `chip_smoke.py`) call
`enable_compile_cache()` before their first compile.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# inside the checkout, listed in .gitignore
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(env: dict[str, str] | None = None) -> str:
    """Return the cache directory in use, setting it if nobody else has.

    `$JAX_COMPILATION_CACHE_DIR`, when set, is the directory: JAX reads it
    itself and nothing else is set here. Otherwise the cache goes to
    `<checkout>/.jax_cache`.
    """
    env = os.environ if env is None else env
    if env.get(ENV_VAR):
        return env[ENV_VAR]
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
