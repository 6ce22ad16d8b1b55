"""One persistent-compilation-cache policy for every entry point.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it at start-up and
nothing here overrides it.  Otherwise the cache lives at a fixed path
inside the checkout (``<checkout>/.jax_cache``, git-ignored): a fixed
path keeps cache keys stable across runs, and nothing is written outside
the checkout.
"""

from __future__ import annotations

import os
from typing import Optional

CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT_DIR, ".jax_cache")
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache(min_compile_time_s: float = 0.5) -> Optional[str]:
    """Point JAX's persistent cache at the checkout unless the environment
    already chose a directory.  Returns the directory this call set, or
    None when the environment variable governs."""
    if os.environ.get(ENV_VAR):
        return None
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_s)
    return DEFAULT_CACHE_DIR
