"""Where the port's compiled kernels live — the counterpart of the JAX
package's persistent XLA compilation cache.

The port compiles its CUDA kernels once per source tree with ``nvcc`` into
``ops/kernels.py::BUILD_ROOT`` (``godot_whisper_tpu_torch/_build/`` by
default) and reuses them in every later process.  The CLI entry points and
the bench call ``enable_compilation_cache()``; library users can call it
explicitly, before the first kernel loads.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional


def enable_compilation_cache(path: Optional[str] = None) -> Path:
    """Point the kernels' build directory at ``path``, else at
    ``$GWT_TORCH_CACHE``, else leave it where it is.  Raises if a kernel
    library was already loaded from another directory: the process would
    otherwise keep running the old build while new ones land elsewhere.
    Returns the build directory."""
    from ..ops import kernels

    target = path or os.environ.get("GWT_TORCH_CACHE")
    if not target:
        return kernels.BUILD_ROOT
    root = Path(target).expanduser().resolve()
    if root != kernels.BUILD_ROOT and kernels.library.cache_info().currsize:
        raise RuntimeError(
            f"kernel libraries are already loaded from {kernels.BUILD_ROOT}; "
            f"enable the cache at {root} before the first kernel runs")
    root.mkdir(parents=True, exist_ok=True)
    kernels.BUILD_ROOT = root
    return root
