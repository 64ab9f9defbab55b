"""ctypes bindings of the port's native capture ring
(``native/audio_frontend.cpp``), the ring of the JAX package's
``native/bindings.py``.

The library is built with ``g++`` at first use into
``godot_whisper_tpu_torch/_build/audio-<key>/libgwt_audio.so``, where
``<key>`` hashes the source and the flags (an edited source rebuilds).  The
flags carry no ``-march=native``, so a build runs on any x86-64 host.  When
no compiler is there, ``available()`` is False and ``runtime/capture.py``
uses its Python ring, which the tests hold the native ring to.  This is
host audio code, not a path of the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "audio_frontend.cpp"
BUILD_ROOT = _DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"audio-{h.hexdigest()[:16]}" / "libgwt_audio.so"


def _build(dst: Path) -> None:
    """Compile the library into ``dst`` (through a private file and a
    rename, so a concurrent loader never sees half a library)."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise OSError("g++ not found")
    dst.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=dst.parent)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, dst)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if it is missing; None when it
    cannot be built (``build_error()`` says why)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            if _build_error is not None:
                return None
            try:
                _build(path)
            except (OSError, subprocess.SubprocessError) as e:
                _build_error = str(getattr(e, "stderr", None) or e)
                return None
        lib = ctypes.CDLL(str(path))

        f32p = ctypes.POINTER(ctypes.c_float)
        lib.gwt_ring_new.restype = ctypes.c_void_p
        lib.gwt_ring_new.argtypes = [ctypes.c_uint64]
        lib.gwt_ring_free.restype = None
        lib.gwt_ring_free.argtypes = [ctypes.c_void_p]
        lib.gwt_ring_push.restype = ctypes.c_uint64
        lib.gwt_ring_push.argtypes = [ctypes.c_void_p, f32p, ctypes.c_uint64]
        lib.gwt_ring_pop.restype = ctypes.c_uint64
        lib.gwt_ring_pop.argtypes = [ctypes.c_void_p, f32p, ctypes.c_uint64]
        lib.gwt_ring_available.restype = ctypes.c_uint64
        lib.gwt_ring_available.argtypes = [ctypes.c_void_p]

        _lib = lib
        return lib


def available() -> bool:
    return load_library() is not None


def build_error() -> Optional[str]:
    """Why the last build failed (None if none failed)."""
    return _build_error


def _require():
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    return lib


def _as_f32(x: np.ndarray):
    x = np.ascontiguousarray(x, dtype=np.float32)
    return x, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeRing:
    """Single-producer single-consumer float ring of the native library;
    a push past the free space drops the rest (AudioEffectCapture's
    behaviour when nobody reads)."""

    def __init__(self, capacity: int):
        self._lib = _require()
        self._h = self._lib.gwt_ring_new(capacity)

    def push(self, data: np.ndarray) -> int:
        arr, ptr = _as_f32(data)
        return int(self._lib.gwt_ring_push(self._h, ptr, len(arr)))

    def pop(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float32)
        _, ptr = _as_f32(out)
        return out[:int(self._lib.gwt_ring_pop(self._h, ptr, n))]

    @property
    def available(self) -> int:
        return int(self._lib.gwt_ring_available(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gwt_ring_free(self._h)
            self._h = None

