"""Persistent XLA compilation cache shared by every entry point.

Compiles are a large fixed cost: the matcher kernel and the batched
pipeline each take many seconds to compile, on the GPU and on the CPU test
mesh alike. JAX's persistent compilation cache reuses an executable
whenever code, shapes and the JAX version are unchanged. The package
``__init__`` calls :func:`enable_persistent_cache` on import, so every
process — pytest, bench.py, chip_smoke.py, the CLIs — shares one cache.

Where it lives:
  * ``JAX_COMPILATION_CACHE_DIR`` set: that directory, read by JAX itself;
    no other directory is set in code.
  * otherwise the fixed ``<repo>/.jax_cache`` (gitignored). The path is
    part of what makes later processes hit, so it does not move.

Note on CPU cache loads: XLA's CPU AOT loader logs two spurious ERROR lines
per cached load ("+prefer-no-scatter is not supported on the host machine")
— the mismatch is in XLA-internal pseudo-features, not real ISA features;
same-machine loads are safe. tests/conftest.py defaults TF_CPP_MIN_LOG_LEVEL
to 3 to keep the suite output readable.
"""

from __future__ import annotations

import os

import jax

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO_ROOT, ".jax_cache")
# entries below this compile time are not persisted (keeps the thousands of
# trivial sub-second test programs out)
MIN_COMPILE_SECONDS = 2.0


def cache_dir() -> str:
    """The directory the compile cache (and the autotune store beside it)
    uses under the rule above."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_persistent_cache() -> str:
    """Turn on jax's persistent compilation cache under the rule above and
    return its directory."""
    d = cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      MIN_COMPILE_SECONDS)
    return d
