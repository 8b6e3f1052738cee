"""Persistent XLA compilation cache.

The fused ladder, the paired program and the GMAP chain stage each take
tens of seconds to compile for one batch shape, while an aligner process
often runs only a few batches.  Keeping the compiled executables on disk
lets the next process of the same checkout load them instead.

Enabled on tpumap import (CLI drivers, bench, tests).  Where
JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this module
sets no directory; otherwise the cache is the fixed directory
`.jax_cache` at the root of the checkout.  Opt out with
TPUMAP_NO_JAX_CACHE=1.
"""
from __future__ import annotations

import os
import pathlib
import sys

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"

_done = False


def cache_dir() -> str | None:
    """The cache directory in effect, or None when the cache is off."""
    if os.environ.get("TPUMAP_NO_JAX_CACHE"):
        return None
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)


def enable() -> None:
    global _done
    if _done or os.environ.get("TPUMAP_NO_JAX_CACHE"):
        return
    _done = True
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            DEFAULT_DIR.mkdir(exist_ok=True)
        except OSError as exc:
            sys.stderr.write(f"tpumap: compilation cache off: cannot "
                             f"create {DEFAULT_DIR} ({exc})\n")
            return
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    # cache every program: the small host-side helpers recompile per
    # process otherwise
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
