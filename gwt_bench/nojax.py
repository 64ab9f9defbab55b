"""The no-JAX check: which of JAX, jaxlib, flax and the JAX package this
process has loaded, compared by whole top-level module names (the part
before the first dot), so ``godot_whisper_tpu_torch`` passes."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "godot_whisper_tpu")


def loaded(modules: Iterable[str] = None) -> List[str]:
    names = {m.split(".", 1)[0] for m in (list(sys.modules) if modules is None
                                          else modules)}
    return sorted(n for n in FORBIDDEN if n in names)
