"""Build and load the port's hand-written CUDA kernels.

Every kernel lives in ``godot_whisper_tpu_torch/csrc/<name>.cu`` with a plain
C entry point.  The first call that needs a kernel compiles ALL sources with
``nvcc`` for ``sm_90a`` (one ``nvcc`` process per source, started together),
each into its own shared library, and loads the one asked for through
``ctypes``.  Libraries land under ``godot_whisper_tpu_torch/_build/<key>/``
where ``<key>`` hashes the sources and the flags, so an edited source
rebuilds and an unchanged tree reuses the previous build
(``runtime/cache.py::enable_compilation_cache`` moves ``BUILD_ROOT``).

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc`` or a card.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("mel", "enc_attn", "enc_attn_long", "decode_attn",
           "filter_sample", "split_attn", "kv_reorder", "qmatmul",
           "cross_attn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "godot_whisper_tpu_torch need the CUDA toolkit")
    return found


def build_key() -> str:
    """Hash of every csrc file and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_ROOT / build_key() / f"lib{name}.so"


def build_all() -> Dict[str, str]:
    """Compile every missing library in parallel; return each source's
    ``nvcc`` log (``-Xptxas -v``: registers, shared memory, spills).
    Raises with the compiler output when a source does not compile."""
    nvcc = _nvcc()
    out_dir = BUILD_ROOT / build_key()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        dst = out_dir / f"lib{name}.so"
        if dst.exists():
            continue
        # compile to a private file, then rename: concurrent builds
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, dst)
    logs, failed = {}, []
    for name, (proc, tmp, dst) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            os.unlink(tmp)
        else:
            os.replace(tmp, dst)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


_BUILD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of csrc/<name>.cu (built on first use;
    threads that need a kernel first at the same time build once)."""
    if name not in SOURCES:
        raise ValueError(f"unknown kernel source {name!r}")
    with _BUILD_LOCK:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        return ctypes.CDLL(str(path))


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
U = ctypes.c_uint


@functools.lru_cache(maxsize=None)
def entry(source: str, symbol: str, argtypes: tuple):
    """A C entry point of csrc/<source>.cu with its argument types set
    (pointers as c_void_p: ctypes would otherwise pass 32-bit ints)."""
    fn = getattr(library(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(fn, what: str, device, *args) -> None:
    """Call a C entry point with ``device``'s current stream as its last
    argument, ``device`` being the calling thread's current CUDA device
    for the call (a kernel launches on the current device, and a worker
    thread starts on device 0 whatever card its tensors lie on); raise if
    it returned a CUDA error (a launch the CUDA runtime refused never runs,
    and a later synchronize would not report it)."""
    import torch
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


_CAPTURE = threading.local()


def count(wrapper, *keyed) -> None:
    """One launch of the kernel wrapper ``wrapper``: ``wrapper.launches``
    and each (Counter, key) of ``keyed`` go up by one.  While this thread
    captures a CUDA graph (``CapturedLaunches``) nothing launches: the
    launch is kept for the graph, which counts it at each replay."""
    calls = getattr(_CAPTURE, "calls", None)
    if calls is not None:
        calls.append((wrapper, keyed))
        return
    wrapper.launches += 1
    for counter, key in keyed:
        counter[key] += 1


class CapturedLaunches:
    """The launches ``count`` sees in a ``with`` block that captures a CUDA
    graph, kept instead of counted; ``add()`` counts them once, at each
    replay of the graph, so the wrappers' counters read the launches the
    card ran.  The wrappers a decoder step launches count through
    ``count``: ``decode_attention``, ``quant_matmul``, ``quant_matmul4``,
    ``xattn_q_packed``, ``xattn_q_wide``."""

    def __enter__(self) -> "CapturedLaunches":
        _CAPTURE.calls = self._calls = []
        return self

    def __exit__(self, *exc) -> None:
        _CAPTURE.calls = None
        self.wrappers = collections.Counter(w for w, _ in self._calls)
        keyed: Dict[int, tuple] = {}
        for _, pairs in self._calls:
            for counter, key in pairs:
                keyed.setdefault(id(counter), (counter, collections.Counter())
                                 )[1][key] += 1
        self.keyed = list(keyed.values())

    def add(self) -> None:
        for wrapper, n in self.wrappers.items():
            wrapper.launches += n
        for counter, delta in self.keyed:
            counter.update(delta)


def require_cuda(what: str, *tensors) -> None:
    """Kernel inputs must be contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: needs contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"{what}: kernel needs CUDA tensors, got {dev}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


MAX_TICKETS = 1 << 16
_TICKETS: Dict[int, object] = {}


def tickets(device, n: int):
    """The per-device int32 counters of the split-cache kernels (K3/K4,
    K7): one per (group, head) pair, zeroed once here; every launch leaves
    them at 0 again, so a captured CUDA graph can replay the kernels.
    Kernels that share them must run in stream order (the port runs on one
    stream)."""
    import torch
    if n > MAX_TICKETS:
        raise ValueError(f"split-cache attention: {n} (group, head) pairs, "
                         f"at most {MAX_TICKETS}")
    t = _TICKETS.get(device.index)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("split-cache attention: call it once on this "
                               "device before capturing a CUDA graph")
        t = _TICKETS[device.index] = torch.zeros(
            MAX_TICKETS, dtype=torch.int32, device=device)
    return t
